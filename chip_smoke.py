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
           cache and minicpm3's MLA latents) and of the tensor-parallel
           ranks of phase (tp) and beyond (Hq 16 / Hkv 4 at hd 128 and 64,
           G 5, llama3-70b's tp-3 layouts G 9 over 3 and 4 KV heads,
           fused_swiglu at the per-rank widths 4784, 2736 and 9560 that the
           ranks run and at the ragged shares 4779, 2731 and 9558 that
           they pad to a multiple of 8),
           and time kernel, plain
           version and the PyTorch call that computes the same function
           (for fused_swiglu a composite of cuBLAS and elementwise calls),
           with CUDA events; fused_swiglu's autograd op at phase (t)'s
           shape (M = B·S 512, K 2048, N 8192, f32): output, dx, dwg and
           dwu against autograd through the plain version, forward and
           backward timed beside the composite and its autograd
  serve    the tree engine at full width, llama3-8b target, f32, bs 8, w 4,
           S_max 512, weights drawn once by ``build_engine(smoke=False)``:
           lockstep ``generate()`` — (a) the serve CLI defaults with the
           llama3-1b draft, 2 of its 3 requests, prompt 16, max_new 48, d from the
           profile pass; (b) self-draft on the same 8B weights, 2 requests,
           max_new 24 —
           then continuous batching through ``ContinuousBatchingRuntime``
           on a wall clock, 2 slots, a seeded Poisson trace of 4 requests
           (prompts 8-16, max_new 32), reduced to the first 8 of the 8B's
           layers and 4 of the 1B's: (c1) lockstep 8B+1B, (c2) async
           rounds 8B+1B (nearly every lookahead rolls back), (c3) async 8B
           self-draft (lookaheads commit), (c4) lockstep 8B self-draft (the
           control of (c3)), (c5) the router: ``ShardedServingRuntime``
           over two replicas of (c2)'s async engine sharing the card (the
           shared-device fallback of ``make_serving_devices``), 1 slot
           each, the fleet report printed, its outputs held against (c2)'s
           solo ``generate()`` (the same engine).  Every output must equal the
           port's own target-only greedy decode (and, in (c), its solo
           ``generate()``); each kernel of a path must have launched in its
           run; each run must make one host sync per round.
  chain    chain-mode speculation, ``ChainSpecEngine.session().generate()``,
           k 4, f32, prompt 16, max_new 16, S_max 512: (d3) llama3-8b +
           llama3-1b on the weights above, parallel, 1 request; then
           zamba2-2.7b at full width, reduced to 12 of its 54 mamba2 layers
           (2 of its 9 units; the shared attention block every 6), weights
           seed 0 with the lm_head x4: (d1)
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
           d 2, 1 request: lockstep, f32, max_new 16, each output equal to
           the greedy decode, one host sync per round
  rwkv6    chain mode on rwkv6-7b at full width, reduced to 4 of its 32
           layers (k 4, f32, max_new 16, 1 request): (g1) self-draft,
           parallel; (g2)/(g2s) an
           independent seed-7 draft reduced to 4 of its 32 layers, parallel
           and serial.  rwkv6 calls none of the port's kernels; each output
           must equal the greedy decode with one host sync per round and
           one per request
  families (h1) deepseek-moe-16b at full depth (a dense layer, then 27 moe
           layers of 64 experts, top 6, 2 shared), (h2) mixtral-8x22b cut
           to 4 of its 56 layers (8 experts, top 2, G 6, sliding window),
           (h3) minicpm3-4b cut to 16 of its 62 layers (MLA), (h4)
           musicgen-large at full depth (hd 64; a prefill of the table's embeddings must
           equal the token prefill bit for bit): each drafting for itself
           at d 2 through the tree engine, lockstep, f32, 1 request,
           max_new 16, the MoE paths drop-free (capacity_factor E / k),
           each output equal to the greedy decode with one host sync per
           round, the greedy decode's launches counted with the run's;
           (h5) llama-3.2-vision-90b cut to one unit (4 dense blocks and a
           cross block) through the Model API: prefill 16 tokens with
           seeded stub encoder states, 16 greedy decode steps, then one
           traced spec_forward of the same tokens under a causal chain
           mask, whose argmax must equal the decode at every position
  train    (t) the single-device trainer, ``launch.train.train``, on
           llama3-1b at full width and depth (1.50 B params, f32, B 2 x S
           256): step 1's gradient finite and non-zero on every trainable
           tensor (wg and wu through fused_swiglu's autograd op), 6 steps
           on one repeated batch lowering its loss by at least 1 nat with
           fused_swiglu launched in every layer, the step time, a traced
           step's device busy share and the peak memory; then, on the
           smoke config (reduced), save/restore bit for bit and a run
           stopped as by a preemption and resumed from its checkpoint
           bit for bit equal to the uninterrupted run
  train2   (t2a) tensor-parallel training: llama3-1b at full width (d 2048,
           d_ff 8192, V 128256, 32/8 heads) cut to 4 of its 16 layers,
           f32, B 2 x S 256, over 2 gloo ranks sharing the card
           (``workers.tp_train``; per rank 16/4 heads, half the
           vocabulary, fused_swiglu at M 512, K 2048, N 4096 inside its
           autograd op), 2 steps against the single-process step on the
           same draws on the card: the losses within 1e-5 relative, the
           joined parameters within 1e-5 of each tensor's scale plus 1e-3 of
           step 1's learning rate, every whole tensor's gradient bit equal on
           both ranks, fused_swiglu in every layer of every step; each
           rank's step time, collectives per step and peak memory printed;
           (t2b) ``launch.train.train`` with mesh_model 2 on 4 gloo ranks
           (2 data x 2 model) on the smoke config: its losses the
           single-process run's on the same global batches, and a run
           stopped before step 6 and resumed from its per-rank checkpoints
           bit for bit equal to the uninterrupted run on every rank
  tp       tensor parallelism, both models sharded over ranks that share
           the one card through gloo (NCCL refuses two ranks on one
           device), each rank a process of its own: (p1) llama3-8b cut to
           8 of its 32 layers with llama3-1b cut to 4 of 16 at tp 2 (per
           rank Hq 16, Hkv 4, fused_swiglu at N 7168 and 4096), lockstep
           then async rounds; (p2) qwen2.5-14b cut to 8 of its 48 layers
           drafting for itself at d 2, tp 3, padded by resolve_for_tp (per
           rank Hq 15, Hkv 3: G 5), lockstep; 1 request, prompt 16, max_new
           16, f32.  Each rank's output must equal the sharded model's
           greedy decode and every other rank's, its prefill logits the
           single-process model's of the same draws (computed before the
           ranks start) within 2e-4, tree_attention, fused_swiglu and
           kv_move_rows must launch on every rank, one host sync of the
           port's per lockstep round (the collectives, staged through the
           host by gloo, are reported apart); (p3) (p1)'s target on an NCCL
           group of one rank in this process: its prefill bit for bit equal
           to the model without a group
  split    (s), the disaggregated engine, run in the ranks of (p1)'s and
           (p2)'s spawns after them (``workers.split_engine``): target and
           draft on disjoint rank groups that share the card through gloo,
           each rank holding its own role's model only, the plan and the
           verdict crossing as world broadcasts: (s1) llama3-8b on rank 0
           and llama3-1b on rank 1 at full width and depth (seeded as
           (a)'s, lm_head x4, S_max 512, bs 8, w 4, c 2, d 2, 1 request,
           prompt 16, max_new 16): lockstep, async rounds and chain mode
           (k 4); (s2) llama3-8b over ranks 0-1 (tp 2) and llama3-1b on
           rank 2, lockstep.  Every rank's output must equal (s1) rank 0's
           single-process greedy decode and rank 0's, with the same stats
           on every rank, one host sync of the port per round (chain: +1
           per request), each role's kernels launched on each of its ranks,
           each rank's parameters its own role's shard alone and its peak
           memory above what it held before, less them, below the other
           role's weights;
           the collectives per round are reported apart
  families (q), tensor parallelism of the other families, run in the same
           spawns after (s): in (p1)'s two ranks (q1) zamba2-2.7b at full
           width cut to 12 of its 54 layers (as (d1); per rank 40 of the
           80 mamba2 heads, the shared block's 16 heads, its MLP N 5120)
           and (q2) rwkv6-7b cut to 4 of its 32 layers (32 of 64 time-mix
           heads, the channel-mix ff 7168), each ``ChainSpecEngine``
           drafting for itself, k 4, parallel, the draft on a process group
           of its own, then (q4) llama-3.2-vision-90b at one unit through
           the Model API as (h5) (Hq 32 / Hkv 4 per rank); in (p2)'s three
           ranks (q3) minicpm3-4b cut to 4 of its 62 layers (MLA, padded to
           42 heads, 14 a rank, d_ff 6402: N 2136) drafting for itself at
           d 2, lockstep; seed 0, lm_head x4, prompt 16, max_new 16 (16
           decode steps).  Every rank's prefill logits within 2e-4 of the
           single-process model's (drawn before the ranks start) and bit
           for bit rank 0's, its output the sharded greedy decode (for (q4)
           its spec_forward's argmax its decode), the chain engine's (q1)
           and (q3)'s kernels launched on every rank ((q2) launches none:
           rwkv6 calls none of the port's kernels), one host sync of the
           port per round (+1 per chain request), each rank's heads, state
           or latent shapes and peak printed
  fleet    (r), router replicas on disjoint rank groups
           (``workers.fleet``): two replicas, each llama3-8b cut to 8 of
           its 32 layers on one rank + llama3-1b cut to 4 of 16 on one rank
           (seeded as (a)'s), four ranks sharing the card through gloo;
           one global queue (``ShardedServingRuntime(fleet=)``), 2 slots
           per replica, 6 requests (prompts of 8-16, max_new 24, one
           arrival every 2 rounds) on a virtual clock, lockstep then async
           rounds.  Every request must equal the target's single-process
           greedy decode (made before the ranks start), every rank hold
           the same results, replicas, stats and merged summary, both
           replicas serve, 1.00 host sync of the port per replica round,
           2.00 / 3.00 split exchanges per replica round on the replica's
           group, 1 fleet exchange per fleet round on the world's gloo
           group, each rank launch its role's kernels and slot_write_rows,
           and no rank hold the other role's weights or another replica's
  dryrun   (y), the dry run against the card: (y1) ``python -m
           repro_torch.launch.dryrun`` (meta tensors, no card; started at
           the script's start in processes of their own on the host's CPU,
           with (y2)'s counts) for qwen2.5-14b at decode_32k, prefill_32k
           and train_4k and zamba2-2.7b at long_500k on pod1, every record
           ``ok``; (y2) memory: phase (t)'s llama3-1b train step (f32) at
           (t)'s B 2 x S 256 and at B 2 x S 2048 (``DRYRUN_MEMORY_SHAPES``)
           with remat "none" and "full", the counted argument bytes within
           1 % of ``torch.cuda.memory_allocated()`` after the weights, the
           AdamW state and the batch are placed, the counted peaks of the
           whole step and of its forward + backward within
           ``DRYRUN_PEAK_TOL`` of ``max_memory_allocated()``, "full"
           saving less for the backward on both sides, and at S 2048,
           where the activations set it, "full"'s forward + backward peak
           below "none"'s on both sides; (y2)
           work (in phase serve, on (a)'s weights): one 8B ``decode_step``
           counted by ``launch/cost.py`` on the card equal to the same
           step counted on meta (operations, bytes, calls per kernel
           wrapper), its roofline time printed beside its measured time;
           (y3) every line where a path of one process synced in its
           rounds ((a)-(c4), (d), (f)-(h); the sync counter's) is a line
           where the port's HOTSYNC rule reports a suppressed finding
  shapes   every shape at which a path called a kernel, held against its
           plain version again, the (p), (s) and (r) ranks' shapes included
           (each rank records its own and hands them back)

Each path prints its launches and a kernel trace of two rounds
(``build/traces/trace_<path>.json``).  The last two lines of standard output
are the ``kernels`` JSON line and the ``{"ok": true, "device": ...}`` line;
any failure exits non-zero before them.  It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

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
TRAIN_B, TRAIN_S = 2, 256  # phase (t)'s batch: B·S = 512 rows through every MLP
SWIGLU_TRAIN = ("1B-train", (TRAIN_B * TRAIN_S, 2048, 8192))  # llama3-1b's MLP at M = B·S, f32
# fused_swiglu's gradients against autograd through the plain version: the output and dx
# at the kernels' f32 2e-5; dwg and dwu (each a sum over the M = 512 rows, entries of order
# sqrt(M)) at 2e-5 of their largest magnitude, since the two sides' products sum the rows
# in cuBLAS's order for their own operand layouts
SWIGLU_GRAD_TOL = 2e-5
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 6, 3e-4, 1  # phase (t): steps on one repeated batch
TRAIN_MARGIN = 1.0  # the repeated batch's loss must fall by at least this (nats) in TRAIN_STEPS
TP_TRAIN = ("llama3-1b", 4, 2)  # (t2a): config at full width, its depth (of 16 layers), tp
TP_TRAIN_STEPS = 2  # (t2a): steps on phase (t)'s first two batches, at TRAIN_LR
SWIGLU_TRAIN_TP = ("1B-train-tp2", (TRAIN_B * TRAIN_S, 2048, 8192 // TP_TRAIN[2]))  # a rank's MLP
MESH_TRAIN = (4, 2)  # (t2b): the world and --mesh-model of launch.train.train (2 data x 2 model)
TRAIN_LOSS_RTOL = 1e-5  # (t2): the sharded losses against the single-process ones
# (t2a): the joined gradient against the single-process one, of each tensor's scale (and the
# clip's norm, relative): tests/test_torch_train_steps.py's tolerance for the gradient
TRAIN_GRAD_TOL = 1e-4
# (t2a): the share of the joined parameters that may lie beyond the smoke tests' tolerance
# (elements whose gradient sits at its tensor's rounding floor), each within one AdamW step
TRAIN_PARAM_SHARE = 1e-6
DRYRUN_CELLS = (("qwen2.5-14b", ("decode_32k", "prefill_32k", "train_4k")),
                ("zamba2-2.7b", ("long_500k",)))  # (y1): pod1
DRYRUN_ARG_TOL = 0.01  # (y2): counted argument bytes against memory_allocated()
DRYRUN_PEAK_TOL = 0.10  # (y2): counted peaks against max_memory_allocated()
DRYRUN_DECODE_LEN = 64  # (y2) work: the 8B decode step's cache length
# (y2) memory: (B, S) of (t)'s train step -> whether the activations set its forward +
# backward peak (at (t)'s own the gradients do, alike under both remats)
DRYRUN_MEMORY_SHAPES = {(TRAIN_B, TRAIN_S): False, (2, 2048): True}
CKPT_STEPS, CKPT_CUT = 8, 6  # phase (t)'s resume check: 8 steps whole, or stopped before step 6
# (checkpoints every 2 steps: the last at step 4) and resumed at step 5
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
CHAIN_K, CHAIN_NEW = 4, 16  # chain length and new tokens per request of phases (d) and (g)
DENSE_NEW = (  # (label, config) of the dense configs of phase (f) and their kernel checks
    ("3B", "llama3-3b"), ("70B", "llama3-70b"), ("ds1.3B", "deepseek-coder-1.3b"),
    ("ds33B", "deepseek-coder-33b"), ("granite", "granite-20b"))
DENSE_NEW_PATHS = {  # (f1)-(f3): target, its depth on the card (None: full), draft (None: self)
    "f1": ("llama3-3b", None, "llama3-1b"),
    "f2": ("deepseek-coder-33b", 8, "deepseek-coder-1.3b"),
    "f3": ("granite-20b", 8, None),
}
DENSE_NEW_TOKENS = 16  # max_new per request of phase (f)
RWKV_DRAFT_LAYERS = 4  # the seed-7 rwkv6-7b draft of (g2)/(g2s), cut from 32
RWKV_LAYERS = 4  # phase (g)'s rwkv6-7b target, cut from 32 to keep the script in its limit
ZAMBA_LAYERS = 12  # phase (d1)-(d2s)'s zamba2-2.7b: 2 of its 9 units (6 mamba2 + the shared block)
SERVE_C_LAYERS = (8, 4)  # phase (c)'s depth: the first layers of the 8B (of 32) and 1B (of 16)
FAMILY_NEW = (  # (label, config, checks) of the families of phase (h): "attention" holds
    # tree and decode attention at its heads, "kv" kv_move_leaves and slot_write_rows at its
    # cache; fused_swiglu is held at every dense MLP
    ("mixtral", "mixtral-8x22b", {"attention"}), ("dsmoe", "deepseek-moe-16b", {"kv"}),
    ("minicpm3", "minicpm3-4b", {"kv"}), ("musicgen", "musicgen-large", {"attention"}),
    ("vision", "llama-3.2-vision-90b", set()))
FAMILY_PATHS = {  # (h1)-(h4): config, its depth on the card (None: full), the kernels it launches
    "h1": ("deepseek-moe-16b", None, MAIN_KERNELS + ("decode_attention",)),
    "h2": ("mixtral-8x22b", 4, ("tree_attention", "kv_move_rows")),  # no dense MLP; decode by tree
    "h3": ("minicpm3-4b", 16, ("fused_swiglu", "kv_move_rows")),  # MLA: no attention kernel
    "h4": ("musicgen-large", None, MAIN_KERNELS + ("decode_attention",)),
}
TP_NEW = (  # (label, config, tp, rank, checks): a tensor-parallel rank's layer shapes
    # ((p1)'s target and draft at tp 2, (p2)'s G 5, the ragged per-rank d_ff of llama3-8b
    # and -1b at tp 3, the two rank layouts of llama3-70b at tp 3: G 9 over 3 or 4 KV heads)
    ("8B-tp2", "llama3-8b", 2, 0, {"attention", "kv"}),
    ("1B-tp2", "llama3-1b", 2, 0, {"attention", "kv"}),
    ("qwen14B-tp3", "qwen2.5-14b", 3, 0, {"attention", "kv"}),
    ("8B-tp3", "llama3-8b", 3, 0, set()), ("1B-tp3", "llama3-1b", 3, 0, set()),
    ("70B-tp3-r0", "llama3-70b", 3, 0, {"attention"}),
    ("70B-tp3-r1", "llama3-70b", 3, 1, {"attention"}),
    # the families' ranks of (q): zamba2's shared block at tp 2 (16 heads, hd 80, G 1; its MLP
    # N 5120), minicpm3 at tp 3 (MLA: no attention kernel; N 2136, the share 2134 padded to
    # 8), llama-3.2-vision at tp 2 (Hq 32 / Hkv 4; N 14336)
    ("zamba2-tp2", "zamba2-2.7b", 2, 0, {"attention"}),
    ("minicpm3-tp3", "minicpm3-4b", 3, 0, set()),
    ("vision-tp2", "llama-3.2-vision-90b", 2, 0, {"attention"}))
TP_PATHS = {  # (p1)/(p2): (target, its depth), (draft, its depth) or None (self), tp, max_new, runs
    "p1": (("llama3-8b", 8), ("llama3-1b", 4), 2, 16, ("lockstep", "async")),  # max_new 32
    # until PR 24, cut with SPLIT_NEW to pay for phase (r)
    "p2": (("qwen2.5-14b", 8), None, 3, 16, ("lockstep",)),
}
SPLIT_PATHS = {  # (s1)/(s2), each run in the spawn of the (p) path named first (one process
    # start and CUDA init per rank serve both): (target, its ranks), (draft, its ranks), runs
    "s1": ("p1", ("llama3-8b", 1), ("llama3-1b", 1), (("lockstep", "tree"), ("async", "tree"),
                                                      ("chain", "chain"))),
    "s2": ("p2", ("llama3-8b", 2), ("llama3-1b", 1), (("lockstep", "tree"),)),
}
SPLIT_NEW = 16  # max_new of (s); 32 until PR 24, cut to pay for phase (r)
SPLIT_KERNELS = {  # (run kind, role) -> the kernels each rank of the role must launch
    ("tree", "target"): MAIN_KERNELS, ("tree", "draft"): MAIN_KERNELS,  # verify + compaction;
    # expansion, fill and re-root
    ("chain", "target"): ("tree_attention", "fused_swiglu"),  # the chain's verify
    ("chain", "draft"): CHAIN_KERNELS,  # decode steps, the commit's chain forward
}
FLEET = (("llama3-8b", 8), ("llama3-1b", 4), 2)  # (r): (target, its depth), (draft, its depth),
# replicas; each replica one target rank + one draft rank: 2 x (1 + 1) ranks
FLEET_SLOTS, FLEET_REQUESTS, FLEET_NEW, FLEET_GAP = 2, 6, 24, 2.0  # (r)'s trace: slots per
# replica, requests (prompts of 8-16), max_new, virtual seconds between arrivals (1 a round)
FLEET_RUNS = ("lockstep", "async")
TP_BACKEND = "gloo"  # several ranks on one card: NCCL refuses two ranks on one device
# the sharded prefill against the single-process one: the sums over heads and ff columns are
# split over the ranks and added by the all-reduce, so they round in another order; the
# reference's own tensor-parallel tolerance (tests/test_sharding.py:65)
TP_LOGIT_TOL = 2e-4
FAMILY_TOKENS = 16  # max_new of (h1)-(h4)
VISION_LAYERS = 5  # (h5): one unit of llama-3.2-vision-90b, 4 dense blocks + 1 cross, of 100
VISION_STEPS = 16  # (h5): prompt 16, then 16 greedy decode steps
FAMILY_TP_PATHS = {  # (q1)-(q4), each run in the spawn of the (p) path named first, after its
    # (s) paths: (that path, engine, config, its depth on the card); the (p) path's tp
    "q1": ("p1", "chain", "zamba2-2.7b", ZAMBA_LAYERS),  # as (d1): 2 of its 9 units
    "q2": ("p1", "chain", "rwkv6-7b", 4),
    "q4": ("p1", "model", "llama-3.2-vision-90b", VISION_LAYERS),  # as (h5): one unit
    "q3": ("p2", "tree", "minicpm3-4b", 4),
}
FAMILY_TP_NEW = 16  # max_new of (q1)-(q3), and (q4)'s decode steps
FAMILY_TP_KERNELS = {  # the kernels each rank of a (q) path must launch
    "q1": CHAIN_KERNELS, "q2": (),  # rwkv6 calls none of the port's kernels
    "q3": ("fused_swiglu", "kv_move_rows"),  # MLA: no attention kernel
    "q4": ("tree_attention", "decode_attention", "fused_swiglu"),
}


def new_shapes() -> dict:
    """label -> the single-layer shapes of a DENSE_NEW or FAMILY_NEW config
    at full width and S 512, or of a TP_NEW rank (its heads, its dense-MLP
    width — its share of the padded d_ff rounded up to a multiple of 8 —
    and, where that rounding widened it, the ragged share too), where its
    paths call a kernel: tree_attention
    (B, n, Hq, Hkv, hd, S) at the verify (n 8) and a draft expansion (n 4)
    and decode_attention (B, Hq, Hkv, hd, S) — of the families only
    mixtral's (G 6) and musicgen's (hd 64), the new head shapes —,
    fused_swiglu (M, K, N) at M 1 and 8 for every dense MLP, the cache's row
    leaves [(U, row width)] for kv_move_leaves (the dense configs and
    deepseek-moe's two groups: k and v of each; minicpm3: the MLA latents),
    and for those two families the serving leaves [U, B 2, S, ...] for
    slot_write_rows."""
    from repro_torch.configs import get_config, resolve_for_tp
    from repro_torch.parallel.shard import Shard

    out = {}
    dense = [(label, name, {"attention", "kv"}) for label, name in DENSE_NEW]
    tp_new = {label: (tp, rank) for label, _, tp, rank, _ in TP_NEW}
    for label, name, checks in dense + list(FAMILY_NEW) + [t[:2] + t[4:] for t in TP_NEW]:
        c, ragged = get_config(name), None
        if label in tp_new:  # the rank's heads and dense-MLP width (its share, padded to 8)
            tp, rank = tp_new[label]
            ragged = resolve_for_tp(c, tp).d_ff // tp  # the share before that padding
            c = Shard(c, rank, tp).local_cfg
        hq, hkv, hd, ff = c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff
        family = label in {f[0] for f in FAMILY_NEW}
        m = out[label] = {}
        if "attention" in checks:
            m.update(verify=(1, 8, hq, hkv, hd, 512), expand=(1, 4, hq, hkv, hd, 512),
                     decode=(1, hq, hkv, hd, 512))
        if "dense" in c.layer_kinds or c.shared_attn_every:  # zamba2's shared block: an MLP
            m["swiglu"] = [(M, c.d_model, N) for N in sorted({ff, ragged or ff}) for M in (1, 8)]
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
    from repro_torch.kernels.work import bound

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


def kv_library(leaves, src, dst, mask, donate):
    """The PyTorch call that computes the same moves: index assignment on
    each leaf (a parallel assignment: the right side is gathered first),
    after ``clone()`` when copying through."""
    from repro_torch.kernels.work import kv_active

    b, s, d = kv_active(src, dst, mask, leaves[0].shape[2])

    def run():
        for x in leaves:
            y = x if donate else x.clone()
            y[:, b, d] = x[:, b, s]

    return run


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
    from repro_torch.kernels import ops, ref, work

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
            n_ops, nbytes = work.tree_attention(q, k, v, mask, data=True)  # the mask's rows
            qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
            timed("tree_attention", f"{label} B{B} n{n} Hq{hq} Hkv{hkv} hd{hd} S{S}", dtype, err,
                  lambda: ops.tree_attention(q, k, v, mask),
                  lambda: ref.tree_attention_ref(q, k, v, mask),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mt, enable_gqa=True),
                  nbytes, n_ops)
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
            kt, vt = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
            timed("decode_attention", f"{label} L{L} B{B} Hq{hq} Hkv{hkv} hd{hd} S{S}", dtype, err,
                  lambda: ops.decode_attention(q, k, v, L),
                  lambda: ref.decode_attention_ref(q, k, v, lens),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q[:, :, None], kt, vt, enable_gqa=True),
                  *work.decode_attention(q, k, v, L)[::-1])

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
                # no single PyTorch call computes silu(x@wg) * (x@wu): the library
                # time is a composite of two cuBLAS products and two elementwise passes
                timed("fused_swiglu", f"{label} M{M} K{K} N{N}", dtype, err,
                      lambda: ops.fused_swiglu(x, wg, wu), lambda: ref.fused_swiglu_ref(x, wg, wu),
                      lambda: torch.nn.functional.silu(x @ wg) * (x @ wu),
                      *work.fused_swiglu(x, wg, wu)[::-1],
                      "(composite: silu(x @ wg) * (x @ wu), 2 cuBLAS + 2 elementwise)")

    check_swiglu_autograd(torch, timer, timed, randn, card)

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
                              *work.kv_move_leaves(use, src, dst, mask, donate=donate,
                                                   data=True)[::-1], note)
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
                          *work.kv_move_leaves(leaves, src, dst, mask, donate=donate,
                                               data=True)[::-1],
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
                  lambda: ref.slot_write_rows_ref(leaves, donors, 1), install_lib,
                  *work.slot_write_rows(leaves, donors, 1)[::-1])
            err = check_slot(f"slot_write_rows {label} zero {dtype}", leaves, None, 1)
            timed("slot_write_rows", f"{label}-zero {what} slot 1 (no donor)", dtype, err,
                  lambda: ops.slot_write_rows(leaves, None, 1),
                  lambda: ref.slot_write_rows_ref(leaves, None, 1), zero_lib,
                  *work.slot_write_rows(leaves, None, 1)[::-1])

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


def check_swiglu_autograd(torch, timer, timed, randn, card) -> None:
    """fused_swiglu in a training forward (phase (t)): at llama3-1b's MLP and
    M = B·S rows, f32, the kernel's autograd op (forward: the kernel;
    backward: ``ops.swiglu_backward``, plain products — the TPU kernel has
    no backward kernel) against autograd through the plain version:
    output, dx, dwg and dwu.  Times the forward beside the plain version and
    the composite ``silu(x@wg) * (x@wu)``, and the backward beside the
    composite's autograd backward."""
    from repro_torch.kernels import ops, ref, work

    label, (M, K, N) = SWIGLU_TRAIN
    x, wg, wu = randn(M, K), randn(K, N, scale=K ** -0.5), randn(K, N, scale=K ** -0.5)
    dh = randn(M, N)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu)]
    plain = [t.clone().requires_grad_(True) for t in (x, wg, wu)]
    before = ops.launch_counts()["fused_swiglu"]
    out = ops.fused_swiglu(*leaves)
    if out.grad_fn is None or ops.launch_counts()["fused_swiglu"] != before + 1:
        fail("fused_swiglu on inputs that require a gradient did not run its kernel in an "
             "autograd op")
    got = (out,) + torch.autograd.grad(out, leaves, dh)
    out_p = ref.fused_swiglu_ref(*plain)
    want = (out_p,) + torch.autograd.grad(out_p, plain, dh)
    errs = []
    for what, g, w in zip(("out", "dx", "dwg", "dwu"), got, want):
        g, w = g.detach(), w.detach()
        tol = SWIGLU_GRAD_TOL * (float(w.abs().max()) if what in ("dwg", "dwu") else 1.0)
        err = max_err(g, w)
        if not torch.allclose(g, w, atol=tol, rtol=SWIGLU_GRAD_TOL):
            fail(f"fused_swiglu autograd {label} M{M} K{K} N{N}: {what} differs from autograd "
                 f"through the plain version by {err:.3e} (tol {tol:.3e})")
        errs.append(f"{what} {err:.2e} (atol {tol:.2e}, rtol {SWIGLU_GRAD_TOL:g})")
    print(f"  fused_swiglu autograd {label} M{M} K{K} N{N} float32 against autograd through the "
          f"plain version: max|err| {', '.join(errs)}")
    timed("fused_swiglu", f"{label} M{M} K{K} N{N} forward", torch.float32,
          max_err(got[0].detach(), want[0].detach()), lambda: ops.fused_swiglu(x, wg, wu),
          lambda: ref.fused_swiglu_ref(x, wg, wu),
          lambda: torch.nn.functional.silu(x @ wg) * (x @ wu),
          *work.fused_swiglu(x, wg, wu)[::-1],
          "(composite: silu(x @ wg) * (x @ wu), 2 cuBLAS + 2 elementwise)")
    label_tp, (M, K, N) = SWIGLU_TRAIN_TP  # a tensor-parallel rank's share in (t2a)
    xt, wgt, wut = randn(M, K), randn(K, N, scale=K ** -0.5), randn(K, N, scale=K ** -0.5)
    err = check_close(f"fused_swiglu {label_tp} {(M, K, N)}", ops.fused_swiglu(xt, wgt, wut),
                      ref.fused_swiglu_ref(xt, wgt, wut), torch.float32)
    timed("fused_swiglu", f"{label_tp} M{M} K{K} N{N} forward", torch.float32, err,
          lambda: ops.fused_swiglu(xt, wgt, wut), lambda: ref.fused_swiglu_ref(xt, wgt, wut),
          lambda: torch.nn.functional.silu(xt @ wgt) * (xt @ wut),
          *work.fused_swiglu(xt, wgt, wut)[::-1],
          "(composite: silu(x @ wg) * (x @ wu), 2 cuBLAS + 2 elementwise)")
    del xt, wgt, wut
    label, (M, K, N) = SWIGLU_TRAIN
    comp = [t.clone().requires_grad_(True) for t in (x, wg, wu)]
    out_c = torch.nn.functional.silu(comp[0] @ comp[1]) * (comp[0] @ comp[2])
    t_bwd = timer(lambda: ops.swiglu_backward(x, wg, wu, dh))
    t_cbwd = timer(lambda: torch.autograd.grad(out_c, comp, dh, retain_graph=True))
    # the backward's least work: 6 products of M·K·N multiply-adds (g and u again, dx's two,
    # dwg and dwu), reading x, wg, wu, dh once and writing dx, dwg, dwu once
    b_ms, b_by = work.bound(*work.swiglu_backward(x, wg, wu)[::-1], torch.float32)
    print(f"  time fused_swiglu backward {label} M{M} K{K} N{N} float32: ops.swiglu_backward "
          f"{t_bwd:.4f} ms (no kernel: the TPU kernel has no backward, so the port's is plain "
          f"products and elementwise ops), composite autograd backward {t_cbwd:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}) on {card}", flush=True)


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
    from repro_torch.kernels import ops, ref, work

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
        n_ops, nbytes = work.int4_matmul(x, *q[:3], group_size=AWQ_GROUP)
        time_row(rows, timer, card, "int4_matmul", f"{label} M{M} K{K} N{N} g{AWQ_GROUP}", dtype,
                 err, lambda: ops.int4_matmul(x, *q[:3], group_size=AWQ_GROUP),
                 lambda: ref.int4_matmul_ref(x, *q[:3], AWQ_GROUP), library, nbytes, n_ops, note)
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


SYNC_SITES: dict = {}  # path label -> where its rounds synced (count_syncs, SyncCounter)


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


def report_trace(prof, label: str, tag: str, rounds: int, wall_ms: float,
                 unit: str = "rounds") -> float | None:
    """Write a finished profile's kernels to ``build/traces/trace_<tag>.json``
    and print them summed by layer, with the idle and both-streams shares of
    ``wall_ms``.  Returns the device busy share (None: no kernel traced)."""
    path = os.path.join(HERE, "build", "traces", f"trace_{tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    with open(path, "w") as f:  # keep the kernels only: the full trace is tens of MB
        json.dump({"traceEvents": kernels}, f)
    if not kernels:
        print(f"{label}: device busy share not measured (the profiler recorded no kernel)")
        return None
    by_layer: dict = {}
    for e in kernels:
        layer = layer_of(e["name"])
        n, ms = by_layer.get(layer, (0, 0.0))
        by_layer[layer] = (n + 1, ms + e["dur"] / 1e3)
    busy = sum(ms for _, ms in by_layer.values())
    both_us, n_streams = both_streams_busy_us(kernels)
    print(f"{label}: traced {rounds} {unit} in {wall_ms:.2f} ms wall, {len(kernels)} kernels on "
          f"{n_streams} stream(s), device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, "
          f"both streams busy {both_us / 1e3:.3f} ms (share {both_us / 1e3 / wall_ms:.4f}); "
          "by layer: " + ", ".join(f"{k} {ms:.3f} ms/{n}" for k, (n, ms) in
                                   sorted(by_layer.items(), key=lambda kv: -kv[1][1])), flush=True)
    return busy / wall_ms


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
    SYNC_SITES[label] = sync_lines
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
    SpecStats, its mean round (ms), tok/s over the wall and TTFT p50 (ms),
    and the solo generate() of every request."""
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
    SYNC_SITES[label] = sorted(set(sc.where))
    print(f"{label}: host syncs made at {SYNC_SITES[label]}", flush=True)
    print(f"{label}: kernel launches {counts}", flush=True)
    if sorted(results) != [r.rid for r in trace]:
        fail(f"{label}: served {sorted(results)}, not every request of the trace")
    sess = eng.session(tp, dp)
    solos = {}
    for r in trace:
        out = results[r.rid]
        ref_toks, margins = refs[r.rid]
        if out != ref_toks[:r.max_new] or len(out) != r.max_new:
            j = next((p for p, (a, b) in enumerate(zip(out, ref_toks)) if a != b), len(out))
            fail(f"{label} request {r.rid}: served output diverges from the greedy decode at "
                 f"position {j} (served {out[j:j + 3]}, greedy {ref_toks[j:j + 3]}); the "
                 f"target's top-2 logit margin there is {margins[min(j, len(margins) - 1)]:.3e}")
        solos[r.rid] = sess.generate(r.prompt.reshape(1, -1), max_new=r.max_new)[0][0]
        if solos[r.rid] != out:
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
    return counts, st, (round_ms, toks / wall, summ["ttft_p50_s"] * 1e3), solos


def serve_fleet(torch, label, eng, tp, dp, trace, refs, solos, card, replicas: int = 2):
    """Serve ``trace`` through ShardedServingRuntime: ``replicas`` replicas of
    ONE engine (the shared-device fallback of ``make_serving_devices`` on one
    card), 1 slot each, on a wall clock.  Every output must equal the greedy
    decode and the engine's solo ``generate()`` (``solos``: that engine's,
    made by ``serve_continuous``); every replica must serve;
    each replica's round makes one host sync; kv_move_rows and
    slot_write_rows launch as a single engine's would, summed over the
    replicas.  Prints the fleet report.  Returns the launch counts."""
    from repro_torch import indexed_device
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_devices
    from repro_torch.obs.clock import monotonic
    from repro_torch.serving import Request, ShardedServingRuntime, WallClock

    pairs = make_serving_devices(1, 1, replicas=replicas)
    card_dev = (indexed_device(eng.device),)
    if any(pair != (card_dev, card_dev) for pair in pairs):
        fail(f"{label}: carving 1 + 1 devices {replicas} times on one card gave {pairs}, not "
             "the shared fallback")
    rt = ShardedServingRuntime([eng] * replicas, tp, dp, n_slots=1, clock=WallClock())
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
    sts = [st.spec_stats for st in rt.steppers]
    rounds = sum(st.rounds for st in sts)
    rollbacks = sum(st.spec_rounds - st.spec_commits for st in sts)
    toks = sum(len(v) for v in results.values())
    where = {r.rid: rt.replica_of(r.rid) for r in trace}
    print(f"{label}: {len(results)} requests over {replicas} replicas of one engine x 1 slot, "
          f"replica of each request {where}, {toks} tokens, rounds per replica "
          f"{[st.rounds for st in sts]}, wall {wall:.2f} s, {toks / wall:.2f} tok/s over the "
          f"wall, async rounds {sum(st.spec_rounds for st in sts)}: {rollbacks} rollbacks; "
          f"{sc.n / max(rounds, 1):.2f} host syncs per replica round on {card}", flush=True)
    print(rt.report(), flush=True)
    print(f"{label}: kernel launches {counts}", flush=True)
    if sorted(results) != [r.rid for r in trace]:
        fail(f"{label}: served {sorted(results)}, not every request of the trace")
    if set(where.values()) != set(range(replicas)):
        fail(f"{label}: requests went to replicas {sorted(set(where.values()))} only")
    for r in trace:
        out = results[r.rid]
        if out != refs[r.rid][0][:r.max_new] or len(out) != r.max_new:
            fail(f"{label} request {r.rid}: served output differs from the greedy decode")
        if solos[r.rid] != out:
            fail(f"{label} request {r.rid}: served output differs from the solo generate()")
    print(f"{label}: every output equals the solo generate() and the greedy decode (reduced: "
          "the solo runs (c2) made on the same engine, not a second set)", flush=True)
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        fail(f"{label}: kernels never launched on the router's path: {missing}")
    if sc.n != rounds:
        fail(f"{label}: {sc.n} host syncs in {rounds} replica rounds, not one per round")
    if counts["kv_move_rows"] != 2 * rounds + rollbacks:
        fail(f"{label}: kv_move_rows launched {counts['kv_move_rows']} times, not "
             f"{2 * rounds + rollbacks}")
    if counts["slot_write_rows"] != 4 * len(trace):
        fail(f"{label}: slot_write_rows launched {counts['slot_write_rows']} times for "
             f"{len(trace)} requests, not 4 per request")
    return counts


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
    SYNC_SITES[label] = sorted(set(sc.where))
    print(f"{label}: host syncs made at {SYNC_SITES[label]}", flush=True)
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
    # reduced: 2 of the serve CLI's 3 requests, to keep the script in its time limit
    prompts = list(make_request_stream(cfgT.vocab_size, 16, 1, 3))[:2]
    print("serve (a): reduced: the first 2 of the serve CLI's 3 requests", flush=True)
    refs = [greedy_decode(torch, eng.target, tp, p, eng.cfg.max_new, eng.S_max_t) for p in prompts]
    counts = {"a": run_path(torch, "main path (a) 8B+1B", eng, tp, dp, prompts, refs, card)}
    check_decode_work(torch, eng.target, tp, eng.S_max_t, card)
    # (b) self-draft, built the way examples/quickstart.py builds it (draft = target)
    # reduced: max_new 24 (was 48), a cut for phase (y)
    cfg_b = SpecConfig(bs=8, w=4, c=2, d=2, mode="parallel", max_new=24)
    eng_b = SpecEngine(eng.target, eng.target, cfg_b, S_max_t=512, S_max_d=512)
    counts["b"] = run_path(torch, "main path (b) 8B self-draft", eng_b, tp, tp, prompts[:2],
                           refs[:2], card)

    # (c) continuous batching: a Poisson trace at the serve CLI's default two
    # requests per second, so that arrivals land mid-round and queue while both
    # slots are busy.  The engines run the first SERVE_C_LAYERS layers of
    # build_engine's weights: (c2) is what build_engine(..., async_rounds=True)
    # builds, at that depth, without drawing them again.  4 requests, the cut
    # depth and the rate (each run waits for the last arrival) keep the whole
    # script inside its time limit
    trace = make_request_trace(cfgT.vocab_size, 4, rate_rps=2.0, prompt_len=(8, 16),
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
    perf, solos = {}, {}
    for tag, label, e, draft_params in runs:
        counts[tag], st, perf[tag], solos[tag] = serve_continuous(
            torch, label, tag, e, tpc, draft_params, trace, refs_c, card)
        if tag == "c2" and st.spec_rounds == st.spec_commits:
            fail(f"{label}: no lookahead rolled back")
        if tag == "c3" and st.spec_commits == 0:
            fail(f"{label}: no lookahead committed")
    # (c5) the router: two replicas of (c2)'s async engine share the card (the shared-device
    # fallback), 1 slot each, on the same trace; reduced: held against the solo generate()
    # that (c2) made on the same engine, not a second one
    counts["c5"] = serve_fleet(torch, "continuous (c5) router, 2 replicas of (c2)", runs[1][2],
                               tpc, dpc, trace, refs_c, solos["c2"], card)
    for asyn, lock in (("c2", "c1"), ("c3", "c4")):  # async against its lockstep twin
        (ra, ta, fa), (rl, tl, fl) = perf[asyn], perf[lock]
        print(f"serve ({asyn}) async against ({lock}) lockstep: mean round {ra:.2f} / {rl:.2f} ms "
              f"({ra / rl - 1:+.1%}), tok/s {ta:.2f} / {tl:.2f} ({ta / tl - 1:+.1%}), TTFT p50 "
              f"{fa:.1f} / {fl:.1f} ms on {card}", flush=True)
    timing("serve (a)-(c5)")

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
    """(d1)-(d2): zamba2-2.7b at full width, ZAMBA_LAYERS deep, chain mode."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.models.api import make_model

    full = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full, n_layers=ZAMBA_LAYERS)
    model = make_model(cfg, "cuda")
    tp, dp = peaked(model.init(0)), peaked(model.init(7))
    n_params = sum(t.numel() for t in tp.parameters())
    print(f"chain: zamba2-2.7b ({n_params / 1e9:.3f} B parameters: {cfg.n_layers} mamba2 layers, "
          f"the shared attention block every {cfg.shared_attn_every}; reduced: {cfg.n_layers} of "
          f"its {full.n_layers} layers, to keep the script in its time limit), f32, target seed "
          f"0 and draft seed 7; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
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
    """(g1)-(g2s): rwkv6-7b chain mode at full width, RWKV_LAYERS deep, f32,
    target seed 0 with the lm_head x4: (g1) drafting for itself, parallel; (g2) an
    independent seed-7 draft of RWKV_DRAFT_LAYERS layers, parallel, and
    (g2s) the same serial.  rwkv6 calls none of the port's kernels.
    Returns the launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.models.api import make_model

    full = get_config("rwkv6-7b")
    cfg = dataclasses.replace(full, n_layers=RWKV_LAYERS)
    model = make_model(cfg, "cuda")
    tp = peaked(model.init(0))
    dcfg = dataclasses.replace(full, n_layers=RWKV_DRAFT_LAYERS)
    dmodel = make_model(dcfg, "cuda")
    dp = peaked(dmodel.init(7))
    print(f"chain: rwkv6-7b ({cfg.param_count() / 1e9:.3f} B parameters, {cfg.n_layers} layers, "
          f"d {cfg.d_model}; reduced: {cfg.n_layers} of its {full.n_layers} layers, to keep the "
          f"script in its time limit), f32, target seed 0; seed-7 draft reduced to "
          f"{RWKV_DRAFT_LAYERS} of {full.n_layers} layers ({dcfg.param_count() / 1e9:.3f} B); "
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


def phase_train(torch, card):
    """(t): the single-device trainer (``launch.train.train``) on llama3-1b
    at full width and depth, f32, B·S = TRAIN_B x TRAIN_S.  Step 1's
    gradient (``launch.steps.loss_and_grads``, the trainer's own) must be
    finite and non-zero on every trainable tensor, the MLP's wg and wu
    included (they come through the fused_swiglu kernel's autograd op);
    TRAIN_STEPS steps on one repeated batch must lower its loss by
    TRAIN_MARGIN and launch fused_swiglu in every layer of every step.
    Prints the step time, one traced step's device busy share and the peak
    memory.  Then the checkpoint on the smoke config: save and restore bit
    for bit, and a run of CKPT_STEPS stopped before step CKPT_CUT (as a
    preemption would) and resumed from its last checkpoint equal to the
    uninterrupted run bit for bit.  Returns
    the launch counts of the full-width run."""
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import make_batch, train
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic
    from repro_torch.optim.adamw import param_leaves

    label = "train (t) llama3-1b"
    cfg = get_config("llama3-1b")
    torch.cuda.empty_cache()
    t0 = monotonic()
    model = make_model(cfg, "cuda")
    params = model.init(0, trainable=True)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batch = make_batch(cfg, ds.batch(0), "cuda")
    loss, grads = loss_and_grads(model, params, batch)
    names = [n for n, _ in params.named_parameters()]
    gmax = [float(g.abs().max()) for g in grads]
    bad = [n for n, g, m in zip(names, grads, gmax) if not (m > 0 and bool(torch.isfinite(g).all()))]
    if bad:
        fail(f"{label}: step 1's gradient is zero or not finite on {bad[:6]} ({len(bad)} tensors)")
    mlp = [m for n, m in zip(names, gmax) if n.endswith(("mlp.wg", "mlp.wu"))]
    print(f"{label}: {cfg.param_count() / 1e9:.2f} B params, f32, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, V {cfg.vocab_size}, batch {TRAIN_B} x {TRAIN_S}; step 1 loss "
          f"{float(loss):.4f}, gradient finite and non-zero on all {len(names)} trainable "
          f"tensors (max|g| from {min(gmax):.3e} to {max(gmax):.3e}; the {len(mlp)} MLP wg/wu "
          f"{min(mlp):.3e} to {max(mlp):.3e}) in {monotonic() - t0:.1f} s", flush=True)
    del params, grads, loss
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR,
                warmup_steps=TRAIN_WARMUP, repeat_batch=True, log_every=1, device="cuda",
                log=lambda m: print(f"{label}: {m}", flush=True))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: a loss is not finite: {losses}")
    if losses[0] - losses[-1] < TRAIN_MARGIN:
        fail(f"{label}: the repeated batch's loss fell by {losses[0] - losses[-1]:.4f}, less "
             f"than {TRAIN_MARGIN} in {TRAIN_STEPS} steps ({losses})")
    if counts["fused_swiglu"] < cfg.n_layers * TRAIN_STEPS:
        fail(f"{label}: fused_swiglu launched {counts['fused_swiglu']} times in {TRAIN_STEPS} "
             f"steps of {cfg.n_layers} layers")
    step_ms = statistics.median(out["step_s"][1:]) * 1e3
    print(f"{label}: {TRAIN_STEPS} steps at peak lr {TRAIN_LR} (warmup {TRAIN_WARMUP}) on one "
          f"repeated batch, loss {losses[0]:.4f} -> {losses[-1]:.4f} (fell "
          f"{losses[0] - losses[-1]:.4f} >= {TRAIN_MARGIN}); step {step_ms:.2f} ms (median of "
          f"steps 2-{TRAIN_STEPS}, host clock, the loss's transfer included), "
          f"{TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB allocated on {card}", flush=True)
    print(f"{label}: kernel launches {counts}", flush=True)
    step = make_train_step(cfg, model, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    params, opt = out["params"], out["opt"]
    del out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the profiler's notes on its cycles
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = monotonic()
            new = step(params, opt, batch)
            float(new[2])
            torch.cuda.synchronize()
            wall_ms = (monotonic() - t1) * 1e3
        busy = report_trace(prof, label, "t", 1, wall_ms, unit="step")
    print(f"{label}: device busy share of a traced step "
          f"{'not measured' if busy is None else f'{busy:.4f}'} on {card}", flush=True)
    del params, opt, new, batch
    torch.cuda.empty_cache()

    small = get_config("llama3-1b", smoke=True)
    print(f"{label} checkpoint: reduced: llama3-1b's smoke config ({small.n_layers} layers, d "
          f"{small.d_model}, V {small.vocab_size}); a full-width state is about 24 GB of disk "
          "per save", flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    kw = dict(steps=CKPT_STEPS, batch=2, seq=32, lr=1e-3, warmup_steps=2, device="cuda",
              log=lambda *_: None)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        whole = train(small, **kw)
        train(small, ckpt=os.path.join(d, "cut"), ckpt_every=2, stop_at=CKPT_CUT, **kw)
        resumed = train(small, ckpt=os.path.join(d, "cut"), ckpt_every=2, **kw)
        cm = CheckpointManager(os.path.join(d, "once"))
        state = (whole["params"], whole["opt"])
        cm.save(CKPT_STEPS - 1, state)
        _, back = cm.restore_latest(state)
    leaves = param_leaves(whole["params"]) + whole["opt"].mu + whole["opt"].nu + \
        whole["opt"].master
    back_leaves = param_leaves(back[0]) + back[1].mu + back[1].nu + back[1].master
    if back[1].step != whole["opt"].step or not all(
            torch.equal(a, b) and a.device == b.device for a, b in zip(leaves, back_leaves)):
        fail(f"{label} checkpoint: a restored state differs from the one saved")
    start = resumed["start"]
    if start != CKPT_CUT - 1:
        fail(f"{label} checkpoint: resumed at step {start}, not {CKPT_CUT - 1}")
    diffs = [max_err(a.detach(), b.detach()) for a, b in
             zip(param_leaves(resumed["params"]), param_leaves(whole["params"]))]
    if max(diffs) != 0.0 or resumed["losses"] != whole["losses"][start:]:
        fail(f"{label} checkpoint: the run resumed at step {start} differs from the "
             f"uninterrupted one: params by up to {max(diffs):.3e}, losses "
             f"{resumed['losses']} against {whole['losses'][start:]}")
    print(f"{label} checkpoint: save/restore of {len(leaves)} tensors bit for bit; a run of "
          f"{CKPT_STEPS} steps stopped before step {CKPT_CUT} and resumed at step {start} from "
          f"its checkpoint of step {start - 1}: params and losses bit for bit equal to the "
          f"uninterrupted run on {card}", flush=True)
    return {"t": counts}


def phase_train_tp(torch, card, log):
    """(t2a): tensor-parallel training — TP_TRAIN's llama3-1b at full width
    cut to its first layers, f32, B·S = TRAIN_B x TRAIN_S, over TP_TRAIN[2]
    gloo ranks that share the card (``workers.tp_train``), TP_TRAIN_STEPS
    steps on the dataset's first batches at TRAIN_LR, against the
    single-process step on the card on the same draws (made before the
    ranks start, kept on the card): the losses within TRAIN_LOSS_RTOL, the
    joined first-batch gradient within TRAIN_GRAD_TOL of each tensor's
    scale, the joined parameters within 1e-5 of each tensor's scale plus
    1e-3 of step 1's learning rate (``tests/test_torch_train_steps.py``'s
    tolerance) but for at most TRAIN_PARAM_SHARE of them, which lie within
    what the gradient's tolerance carries through AdamW and within one
    step, the gradient of every tensor the ranks hold whole bit equal on every
    rank, and fused_swiglu launched in every layer of every step on every
    rank at the rank's width.  Prints each rank's step time, collectives
    per step and peak memory.

    (t2b): ``launch.train.train`` with ``mesh_model`` 2 on MESH_TRAIN's four
    gloo ranks (2 data x 2 model) on the smoke config
    (``workers.mesh_train``): its losses the single-process run's on the
    same global batches, and a run stopped before step CKPT_CUT and resumed
    from its per-rank checkpoints bit for bit equal to the uninterrupted
    run on every rank.  Returns the launch counts of both."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.api import make_model
    from repro_torch.models.transformer import param_where
    from repro_torch.obs.clock import monotonic
    from repro_torch.optim import adamw_init, warmup_cosine
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel.shard import Shard
    from repro_torch.parallel.spawn import run_ranks

    name, depth, tp = TP_TRAIN
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=depth)
    label = f"(t2a) train {name}/{depth} tp {tp}"
    print(f"{label}: reduced (depth: {depth} of {full.n_layers} layers; d {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, V {cfg.vocab_size}, {cfg.n_heads}/{cfg.n_kv_heads} heads at full width), "
          f"f32, batch {TRAIN_B} x {TRAIN_S}, {TP_TRAIN_STEPS} steps at peak lr {TRAIN_LR}; the "
          f"ranks share the card through {TP_BACKEND}: correctness, no tensor-parallel speed "
          "figure", flush=True)
    lr = dict(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TP_TRAIN_STEPS)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batches = [ds.batch(k) for k in range(TP_TRAIN_STEPS)]
    t0 = monotonic()
    torch.cuda.empty_cache()
    model = make_model(cfg, "cuda")
    params = model.init(0, trainable=True)
    names = [n for n, _ in params.named_parameters()]
    _, grads = loss_and_grads(model, params, batches[0])
    want_gnorm = float(global_norm([g.float() for g in grads]))
    # kept on the card beside the ranks (9.2 GB), which the comparisons below run on
    want_grads = {n: g.detach() for n, g in zip(names, grads)}
    del grads
    step, opt, want_losses = make_train_step(cfg, model, **lr), adamw_init(params), []
    for b in batches:
        params, opt, loss = step(params, opt, b)
        want_losses.append(float(loss))
    want = {n: p.detach() for n, p in params.named_parameters()}
    # the second moment, bias-corrected: how far each element's update moves per unit of gradient
    vhat = {n: (v / (1 - 0.95 ** TP_TRAIN_STEPS)).sqrt() for n, v in zip(names, opt.nu)}
    del model, params, opt, step, loss
    torch.cuda.empty_cache()
    t1 = monotonic()
    job = {"cfg": cfg, "weights": ("seed", 0, 1.0), "batches": batches, "lr": lr,
           "record_shapes": True, "all_grads": True}
    ranks = run_ranks("repro_torch.parallel.workers:tp_train", tp, (job,),
                      workdir=os.path.join(HERE, "build", "tp_train"), device="cuda:0",
                      backend=TP_BACKEND, timeout_s=300, threads=2)
    print(f"{label}: single-process reference {t1 - t0:.1f} s; {tp} ranks started, drew their "
          f"shards, trained and handed back their gradients and parameters in "
          f"{monotonic() - t1:.1f} s", flush=True)
    lr1 = float(warmup_cosine(1, **lr))
    shard = Shard(cfg, 0, tp)
    worst_g = worst_p = 0.0
    plain_over, n_el = {}, 0
    for pname in names:
        where = param_where(pname)
        g = shard.join(*where, [torch.from_numpy(r["grads"][pname]).cuda() for r in ranks])
        wg = want_grads.pop(pname)
        g_tol = TRAIN_GRAD_TOL * float(wg.abs().max())
        err = max_err(g, wg)
        if g.shape != wg.shape or not torch.allclose(g, wg, rtol=TRAIN_GRAD_TOL, atol=g_tol):
            fail(f"{label}: the joined gradient of {pname} differs from the single-process "
                 f"one by {err:.3e} (tolerance {g_tol:.3e})")
        worst_g = max(worst_g, err / g_tol)
        got = shard.join(*where, [torch.from_numpy(r["params"][pname]).cuda() for r in ranks])
        w = want.pop(pname)
        tol = 1e-5 * float(w.abs().max()) + 1e-3 * lr1
        # what the gradient's tolerance admits through AdamW: a gradient error g_tol moves an
        # element by up to lr1 * g_tol / sqrt(v-hat) (an element whose gradient sits at its
        # tensor's rounding floor takes a whole step whatever that floor's bits), and never by
        # more than one step, lr1 (|m-hat| / sqrt(v-hat) <= 1.0003 after two steps): a step
        # taken the other way, 2 x lr1, fails
        adam_tol = tol + torch.clamp(lr1 * g_tol / (vhat.pop(pname) + 1e-8), max=lr1)
        d = (got - w).abs()
        if got.shape != w.shape or bool((d > adam_tol + 1e-5 * w.abs()).any()):
            fail(f"{label}: the joined {pname} differs from the single-process step's by "
                 f"{float(d.max()):.3e} beyond the tolerance AdamW carries from the gradient's")
        over, n_el = int((d > tol + 1e-5 * w.abs()).sum()), n_el + w.numel()
        if over:
            plain_over[pname] = over
        worst_p = max(worst_p, float(d.max()) / tol)
    torch.cuda.empty_cache()  # the single-process state, popped above, back to the card
    if sum(plain_over.values()) > TRAIN_PARAM_SHARE * n_el:
        fail(f"{label}: {sum(plain_over.values())} of {n_el} joined parameters lie beyond the "
             f"smoke tests' tolerance, more than {TRAIN_PARAM_SHARE:g} of them: {plain_over}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ALL_KERNELS}
    whole = ranks[0]["whole_grads"]
    for r in ranks:
        if not np.allclose(r["losses"], want_losses, rtol=TRAIN_LOSS_RTOL, atol=0.0) or \
                r["losses"] != ranks[0]["losses"]:
            fail(f"{label} rank {r['rank']}: losses {r['losses']} against the single-process "
                 f"{want_losses} (rtol {TRAIN_LOSS_RTOL}) and rank 0's {ranks[0]['losses']}")
        if r["whole_grads"].keys() != whole.keys() or not all(
                np.array_equal(g, whole[n]) for n, g in r["whole_grads"].items()):
            fail(f"{label} rank {r['rank']}: a whole tensor's gradient differs from rank 0's")
        n_mlp = r["launches"]["fused_swiglu"]
        seen = {k[:3] for k in r["shapes"]["fused_swiglu"]}
        if n_mlp < depth * TP_TRAIN_STEPS or SWIGLU_TRAIN_TP[1] not in seen:
            fail(f"{label} rank {r['rank']}: fused_swiglu launched {n_mlp} times at {seen}, not "
                 f"in every one of {depth} layers x {TP_TRAIN_STEPS} steps at "
                 f"{SWIGLU_TRAIN_TP[1]}")
        for kname, keys in r["shapes"].items():
            log.seen[kname] |= keys
        if r["gnorm"] != ranks[0]["gnorm"] or not math.isclose(r["gnorm"], want_gnorm,
                                                                rel_tol=TRAIN_GRAD_TOL):
            fail(f"{label} rank {r['rank']}: the clip's norm over the group {r['gnorm']} against "
                 f"one process's {want_gnorm} (rtol {TRAIN_GRAD_TOL}) and rank 0's")
        coll = {k: v // TP_TRAIN_STEPS for k, v in r["collectives"].items() if v}
        print(f"{label} rank {r['rank']}: losses {r['losses']} (single process {want_losses}), "
              f"step {np.median(r['step_s']) * 1e3:.2f} ms (median, host clock, {TP_BACKEND} "
              f"ranks sharing the card), {coll} collectives per step, peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, fused_swiglu {n_mlp} launches at (M, K, N) "
              f"{sorted(seen)}, gradients of the {len(whole)} whole tensors bit equal to rank "
              f"0's on {card}", flush=True)
    print(f"{label}: the clip's norm {ranks[0]['gnorm']:.7g} (one process {want_gnorm:.7g}); the "
          f"joined first-batch gradient within {worst_g:.4f} of its tolerance ({TRAIN_GRAD_TOL:g} "
          f"of each tensor's scale); the joined parameters after {TP_TRAIN_STEPS} steps within "
          f"the tolerance AdamW carries from it, and at most {worst_p:.3f} x the smoke tests' "
          f"(1e-5 of each tensor's scale + 1e-3 x lr {lr1:g}), which "
          f"{sum(plain_over.values())} of {n_el} elements exceed ({plain_over}); kernel launches "
          f"summed over the ranks {launches}", flush=True)

    small = get_config(name, smoke=True)
    world, mesh_model = MESH_TRAIN
    label = f"(t2b) launch.train.train {name} smoke, world {world}, mesh_model {mesh_model}"
    kw = dict(steps=CKPT_STEPS, batch=4, seq=32, lr=1e-3, warmup_steps=2, ckpt_every=2)
    t0 = monotonic()
    want = train(small, device="cuda", log=lambda *_: None,
                 **{k: v for k, v in kw.items() if k != "ckpt_every"})["losses"]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        job = {"cfg": small, "kw": kw, "mesh_model": mesh_model, "ckpt": d, "cut": CKPT_CUT}
        mesh = run_ranks("repro_torch.parallel.workers:mesh_train", world, (job,),
                         workdir=os.path.join(HERE, "build", "mesh_train"), device="cuda:0",
                         backend=TP_BACKEND, timeout_s=300, threads=2)
    for r in mesh:
        if not np.allclose(r["losses"], want, rtol=TRAIN_LOSS_RTOL, atol=0.0):
            fail(f"{label} rank {r['rank']}: losses {r['losses']} against the single-process "
                 f"run's {want} on the same global batches (rtol {TRAIN_LOSS_RTOL})")
        if r["start"] != CKPT_CUT - 1 or not r["bit_equal"] or \
                r["resumed_losses"] != r["losses"][r["start"]:]:
            fail(f"{label} rank {r['rank']}: the run resumed at step {r['start']} differs from "
                 "the uninterrupted one (parameters, moments, masters and losses must be bit "
                 "for bit)")
    print(f"{label}: 2 data x 2 model ranks on the card through {TP_BACKEND}, {CKPT_STEPS} "
          f"steps of {kw['batch']} x {kw['seq']} in {monotonic() - t0:.1f} s with the "
          f"single-process run; losses {mesh[0]['losses']} within {TRAIN_LOSS_RTOL} of the "
          f"single-process run's; a run stopped before step {CKPT_CUT} and resumed at step "
          f"{CKPT_CUT - 1} from its per-rank checkpoints: parameters, moments, masters and losses "
          f"bit for bit equal to the uninterrupted run on all {world} ranks on {card}", flush=True)
    return {"t2a": launches,
            "t2b": {k: sum(r["launches"][k] for r in mesh) for k in ALL_KERNELS}}


def phase_tp(torch, card, log):
    """(p1)/(p2): the tree engine with target and draft sharded over ranks
    that share the card (gloo), each rank a process that ``run_ranks``
    starts (``parallel.workers.spec_engine``), its weights drawn tensor by
    tensor and sliced as drawn.  Before the ranks start, the single-process
    model of the same draws gives the reference prefill logits (kept on the
    host, the weights freed: the card holds every copy once); on (p1)'s it
    also runs (p3), the sharded model on an NCCL group of one rank, whose
    prefill must equal it bit for bit.  Every rank's output must equal the
    sharded target's greedy decode and the other ranks', its prefill
    logits the reference's within TP_LOGIT_TOL, its runs launch the main
    path's kernels and make one host sync of the port's per lockstep
    round; the collectives per round (each staged through the host by
    gloo) are reported apart.  The (s) paths of SPLIT_PATHS run in the
    same ranks after their (p) path (``workers.several``), checked by
    ``report_split``.  The shapes at which each rank launched a kernel join
    ``log`` (a ``ShapeLog``), for phase_shapes to hold."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import make_request_stream
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel import init_tp, shutdown_tp
    from repro_torch.parallel.shard import shard_params
    from repro_torch.parallel.spawn import run_ranks

    counts = {}
    work = os.path.join(HERE, "build", "tp")
    print(f"tensor parallel: the ranks share the one card through {TP_BACKEND} (NCCL refuses two "
          "ranks on one device), so a round here checks correctness and is no tensor-parallel "
          "speed figure", flush=True)
    split_greedy = {}
    for path, ((tname, tdepth), draft, tp, max_new, runs) in TP_PATHS.items():
        tcfg = dataclasses.replace(get_config(tname), n_layers=tdepth)
        dcfg = None if draft is None else dataclasses.replace(get_config(draft[0]),
                                                              n_layers=draft[1])
        prompt = next(make_request_stream(tcfg.vocab_size, 16, 1, 1, seed=11))
        label = (f"({path}) {tname}/{tdepth}" + ("" if dcfg is None else
                                                  f" + {draft[0]}/{draft[1]}") + f" tp {tp}")
        print(f"{label}: reduced (depth: target {tdepth} of {get_config(tname).n_layers} layers"
              + ("" if dcfg is None else f", draft {draft[1]} of "
                 f"{get_config(draft[0]).n_layers}") + ")", flush=True)
        T = make_model(tcfg, "cuda")
        tparams = T.init(0)
        tparams.lm_head.mul_(4.0)
        ref = T.prefill(tparams, prompt, S_max=512)[0]
        torch.cuda.synchronize()
        if path == "p1":
            store = os.path.join(work, "p3", "store")
            os.makedirs(os.path.dirname(store), exist_ok=True)
            if os.path.exists(store):
                os.remove(store)
            group = init_tp("cuda:0", "nccl", rank=0, world_size=1, store_path=store)
            Tn = make_model(tcfg, "cuda", group)
            got = Tn.prefill(shard_params(tcfg, tparams, group), prompt, S_max=512)[0]
            torch.cuda.synchronize()
            shutdown_tp()
            if not torch.equal(got, ref):
                fail(f"(p3) {tname}/{tdepth} on an NCCL group of one rank: the prefill differs "
                     f"from the model without a group by {max_err(got, ref):.3e} (must be bit "
                     "for bit)")
            print(f"(p3) {tname}/{tdepth} on an NCCL group of one rank: prefill logits "
                  f"{tuple(got.shape)} bit for bit equal to the model without a group on {card}",
                  flush=True)
            del Tn, got
        ref = ref.cpu().numpy()
        del T, tparams
        torch.cuda.empty_cache()
        kw = dict(bs=8, w=4, c=2, d=2, max_new=max_new)
        job = {"tcfg": tcfg, "dcfg": dcfg, "weights": ("seed", 0, 1, 4.0), "prompts": [prompt],
               "runs": [(run, dict(kw, async_rounds=run == "async")) for run in runs],
               "S_max": 512, "greedy_n": max_new, "prefill_logits": True, "sync_rounds": 2,
               "record_shapes": True,
               "trace_rounds": 2, "trace_path": os.path.join(HERE, "build", "traces",
                                                             f"trace_{path}")}
        os.makedirs(os.path.dirname(job["trace_path"]), exist_ok=True)
        calls = [("spec_engine", (job,))]
        splits = [name for name, sp in SPLIT_PATHS.items() if sp[0] == path]
        calls += [("split_engine", (split_job(name),)) for name in splits]
        families = [name for name, fp in FAMILY_TP_PATHS.items() if fp[0] == path]
        t0 = monotonic()
        family_refs = {name: family_tp_job(torch, name, tp) for name in families}
        if families:
            print(f"{label}: the single-process prefill logits of "
                  f"{', '.join(f'({n})' for n in families)} in {monotonic() - t0:.1f} s, each "
                  "model freed before the next", flush=True)
        calls += [family_refs[name][0] for name in families]
        t0 = monotonic()
        out = run_ranks("repro_torch.parallel.workers:several", tp, (calls,),
                        workdir=os.path.join(work, path), device="cuda:0", backend=TP_BACKEND,
                        timeout_s=540, threads=2)
        ranks = [r[0] for r in out]
        after = splits + families
        print(f"{label}: {tp} ranks started, drew their shards and ran"
              + (f" (and {', '.join(f'({n})' for n in after)} after it)" if after else "")
              + f" in {monotonic() - t0:.1f} s; heads / KV heads per rank: target "
              f"{[r['heads']['target'] for r in ranks]}, draft "
              f"{[r['heads']['draft'] for r in ranks]}", flush=True)
        for r in ranks:
            for name, keys in r["shapes"].items():
                log.seen[name] |= keys
            err = float(np.abs(r["prefill_logits"] - ref).max())
            if not np.allclose(r["prefill_logits"], ref, atol=TP_LOGIT_TOL, rtol=TP_LOGIT_TOL):
                fail(f"{label} rank {r['rank']}: prefill logits differ from the single-process "
                     f"model's by {err:.3e} (tolerance {TP_LOGIT_TOL})")
            if not np.array_equal(r["prefill_logits"], ranks[0]["prefill_logits"]) or \
                    r["greedy"] != ranks[0]["greedy"]:
                fail(f"{label} rank {r['rank']}: its logits or greedy decode differ from rank 0's")
            print(f"{label} rank {r['rank']}: prefill logits max|err| {err:.3e} against the "
                  f"single-process model (tolerance {TP_LOGIT_TOL}), bit for bit equal to rank "
                  "0's", flush=True)
        greedy = ranks[0]["greedy"][0]
        for run in runs:
            per = [r["runs"][run] for r in ranks]
            for r, got in zip(ranks, per):
                toks = got["tokens"][0]
                if toks != greedy[:len(toks)] or len(toks) != max_new:
                    j = next((i for i, (a, b) in enumerate(zip(toks, greedy)) if a != b),
                             len(toks))
                    fail(f"{label} {run} rank {r['rank']}: output diverges from the sharded "
                         f"greedy decode at position {j}")
                if toks != per[0]["tokens"][0]:
                    fail(f"{label} {run} rank {r['rank']}: output differs from rank 0's")
                missing = [k for k in MAIN_KERNELS if got["launches"][k] == 0]
                if missing:
                    fail(f"{label} {run} rank {r['rank']}: kernels never launched: {missing}")
                if run == "lockstep" and got.get("syncs_per_round") != 1.0:
                    fail(f"{label} {run} rank {r['rank']}: {got.get('syncs_per_round')} host "
                         "syncs of the port per round, not one")
            st, tr = per[0]["stats"][0], per[0].get("trace")
            rounds = st["rounds"]
            coll = sum(per[0]["collectives"].values())
            counts[f"{path}-{run}"] = {k: sum(g["launches"][k] for g in per) for k in ALL_KERNELS}
            print(f"{label} {run}: {rounds} rounds, compression "
                  f"{sum(st['emitted_rows']) / max(rounds, 1):.3f}, mean round "
                  f"{per[0]['wall_s'] / max(rounds, 1) * 1e3:.2f} ms ({TP_BACKEND}, {tp} ranks on "
                  f"one card: no speed figure), {coll / max(rounds, 1):.1f} collectives per round "
                  f"staged through the host by {TP_BACKEND} ({per[0]['collectives']}), "
                  + (f"{per[0]['syncs_per_round']:.2f} host syncs of the port per round, "
                     if "syncs_per_round" in per[0] else "")
                  + f"every rank's output equals the sharded greedy decode, on {card}", flush=True)
            if tr:
                print(f"{label} {run}: rank 0 traced {tr['rounds']} rounds in {tr['wall_ms']:.2f} "
                      f"ms wall, {tr['kernels'] / tr['rounds']:.1f} kernels per round, device busy "
                      f"{tr['busy_ms']:.3f} ms, idle share {1 - tr['busy_ms'] / tr['wall_ms']:.4f} "
                      "(its own kernels; the other ranks share the card)", flush=True)
            print(f"{label} {run}: kernel launches summed over the ranks "
                  f"{counts[f'{path}-{run}']}", flush=True)
        for i, name in enumerate(splits, start=1):
            counts.update(report_split(name, [r[i] for r in out], split_greedy, card, log))
        for i, name in enumerate(families, start=1 + len(splits)):
            counts[name] = report_family_tp(name, tp, [r[i] for r in out], family_refs[name][1],
                                            card, log)
    return counts


def family_tp_job(torch, name: str, tp: int):
    """((rank program, args), reference prefill logits) of a FAMILY_TP_PATHS
    path at ``tp``: the config at its depth, seed 0, lm_head x4, one prompt
    of 16 (and, for the model of cross blocks, seeded stub encoder states);
    the reference is the single-process model of the same draws on the
    card, freed before the next is drawn."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import make_request_stream
    from repro_torch.models.api import make_model
    from repro_torch.parallel.workers import encoder_states

    _, kind, arch, depth = FAMILY_TP_PATHS[name]
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    prompt = next(make_request_stream(cfg.vocab_size, 16, 1, 1, seed=11))
    model = make_model(cfg, "cuda")
    params = peaked(model.init(0))
    enc = encoder_states(cfg, 0).cuda() if kind == "model" else None
    ref = model.prefill(params, prompt, enc=enc, S_max=512)[0].cpu().numpy()
    del model, params, enc
    torch.cuda.empty_cache()
    if kind == "model":
        return ("model_api", ({"cfg": cfg, "weights": ("seed", 0, 4.0), "prompt": prompt,
                               "enc_seed": 0, "steps": FAMILY_TP_NEW, "S_max": 512,
                               "record_shapes": True},)), ref
    job = {"tcfg": cfg, "dcfg": None, "weights": ("seed", 0, 0, 4.0), "prompts": [prompt],
           "S_max": 512, "greedy_n": FAMILY_TP_NEW, "prefill_logits": True, "record_shapes": True}
    if kind == "chain":
        job["runs"] = [("parallel", dict(k=CHAIN_K, mode="parallel", max_new=FAMILY_TP_NEW))]
        return ("chain_engine", (job,)), ref
    job.update(runs=[("lockstep", dict(bs=8, w=4, c=2, d=2, max_new=FAMILY_TP_NEW))],
               sync_rounds=2)
    return ("spec_engine", (job,)), ref


def report_family_tp(name: str, tp: int, ranks, ref, card, log) -> dict:
    """Check and print one (q) path's ranks: every rank's prefill logits
    within TP_LOGIT_TOL of the single-process model's (``ref``) and bit for
    bit rank 0's, its output equal to the sharded target's greedy decode
    (the chain and tree engines) or its spec_forward's argmax to its decode
    (the Model API) and to rank 0's, the path's kernels launched on every
    rank, one host sync of the port per round (+1 per chain request; the
    collectives apart), and each rank's heads, state or latent shapes and
    peak memory.  Returns the launches summed over the ranks."""
    import numpy as np

    _, kind, arch, depth = FAMILY_TP_PATHS[name]
    label = f"({name}) {arch}/{depth} tp {tp}"
    where = f"{TP_BACKEND}, {tp} ranks on one card: no speed figure"
    for r in ranks:
        for kname, keys in r["shapes"].items():
            log.seen[kname] |= keys
        err = float(np.abs(r["prefill_logits"] - ref).max())
        if not np.allclose(r["prefill_logits"], ref, atol=TP_LOGIT_TOL, rtol=TP_LOGIT_TOL):
            fail(f"{label} rank {r['rank']}: prefill logits differ from the single-process "
                 f"model's by {err:.3e} (tolerance {TP_LOGIT_TOL})")
        if not np.array_equal(r["prefill_logits"], ranks[0]["prefill_logits"]):
            fail(f"{label} rank {r['rank']}: its prefill logits differ from rank 0's")
        if kind == "chain":
            lay = r["layout"]["target"]
            heads = f"heads {lay['heads']}, recurrent heads {lay['ssm_heads']}"
        else:
            heads = f"heads {r['heads']['target'] if kind == 'tree' else r['heads']}"
        shapes = {}  # the first unit's leaves, one of each shape
        for k, v in r["leaves"].items():
            if k.startswith("0.") and v not in shapes.values():
                shapes[k] = v
        print(f"{label} rank {r['rank']}: prefill logits max|err| {err:.3e} against the "
              f"single-process model (tolerance {TP_LOGIT_TOL}), bit for bit equal to rank 0's; "
              f"{heads}; cache leaves [U, B, ...] {shapes}"
              + (f"; peak {r['peak_allocated'] / 2**30:.2f} GiB" if "peak_allocated" in r else "")
              + f" on {card}", flush=True)
    if kind == "model":
        runs = {"model": ranks}
    else:
        runs = {run: [r["runs"][run] for r in ranks] for run in ranks[0]["runs"]}
    for run, per in runs.items():
        for r, got in zip(ranks, per):
            if kind == "model":
                toks, want = got["spec_argmax"], got["decode"][1:]
                if toks != want or got["decode"] != ranks[0]["decode"]:
                    fail(f"{label} rank {r['rank']}: spec_forward's argmax {toks} differs from "
                         f"the decode's tokens {want} or the decode from rank 0's")
            else:
                toks, want = got["tokens"][0], r["greedy"][0]
                if toks != want[:len(toks)] or len(toks) != FAMILY_TP_NEW:
                    j = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b), len(toks))
                    fail(f"{label} {run} rank {r['rank']}: output diverges from the sharded "
                         f"greedy decode at position {j}")
                if toks != per[0]["tokens"][0] or got["stats"] != per[0]["stats"]:
                    fail(f"{label} {run} rank {r['rank']}: tokens or stats differ from rank 0's")
            missing = [k for k in FAMILY_TP_KERNELS[name] if got["launches"][k] == 0]
            if missing:
                fail(f"{label} {run} rank {r['rank']}: kernels never launched: {missing}")
            if kind == "chain" and got["syncs"]["syncs"] != got["rounds"] + 1:
                fail(f"{label} {run} rank {r['rank']}: {got['syncs']['syncs']} host syncs of "
                     f"the port in {got['rounds']} rounds of one request, not one per round and "
                     "one for the request")
            if kind == "tree" and got.get("syncs_per_round") != 1.0:
                fail(f"{label} {run} rank {r['rank']}: {got.get('syncs_per_round')} host syncs "
                     "of the port per round, not one")
        counts = {k: sum(g["launches"][k] for g in per) for k in ALL_KERNELS}
        if kind == "model":
            print(f"{label}: prefill with stub encoder states, {FAMILY_TP_NEW} greedy decode "
                  f"steps and one spec_forward of the same tokens under a causal chain mask: "
                  f"argmax equal at all {FAMILY_TP_NEW} positions on every rank ({where}) on "
                  f"{card}", flush=True)
        else:
            st, rounds = per[0]["stats"][0], per[0]["stats"][0]["rounds"]
            emitted = st["emitted"] if kind == "chain" else sum(st["emitted_rows"])
            coll = per[0]["collectives"]
            print(f"{label} {run}: {rounds} rounds, compression {emitted / max(rounds, 1):.3f}, "
                  f"mean round {per[0]['wall_s'] / max(rounds, 1) * 1e3:.2f} ms ({where}), "
                  + ("1.00 host syncs of the port per round (+1 for the request's first token)"
                     if kind == "chain" else
                     f"{per[0]['syncs_per_round']:.2f} host syncs of the port per round")
                  + f" on every rank, {sum(coll.values()) / max(rounds, 1):.1f} collectives per "
                  f"round staged through the host by {TP_BACKEND} ({coll}), every rank's output "
                  f"equals the sharded greedy decode, on {card}", flush=True)
        print(f"{label} {run}: kernel launches summed over the ranks {counts}"
              + ("" if FAMILY_TP_KERNELS[name] else " (rwkv6 calls none of the port's kernels)"),
              flush=True)
    return counts


def split_job(name: str) -> dict:
    """The ``workers.split_engine`` job of a SPLIT_PATHS path: both models at
    full width and depth, drawn as ``build_engine`` draws them (target seed
    0, draft seed 1, lm_head x4), one request of the serve CLI's prompt
    length."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_request_stream

    _, (tname, n_t), (dname, _), runs = SPLIT_PATHS[name]
    tcfg, dcfg = get_config(tname), get_config(dname)
    tree = dict(bs=8, w=4, c=2, d=2, max_new=SPLIT_NEW)
    kw = {"lockstep": tree, "async": dict(tree, async_rounds=True),
          "chain": dict(k=CHAIN_K, mode="parallel", max_new=SPLIT_NEW)}
    return {"n_target": n_t, "tcfg": tcfg, "dcfg": dcfg, "weights": ("seed", 0, 1, 4.0),
            "prompts": [next(make_request_stream(tcfg.vocab_size, 16, 1, 1, seed=11))],
            "runs": [(run, kind, kw[run]) for run, kind in runs], "S_max": 512,
            "greedy_n": SPLIT_NEW if n_t == 1 else 0, "sync_rounds": 2, "record_shapes": True}


def report_split(name, ranks, greedy, card, log, backend=TP_BACKEND) -> dict:
    """Check and print one (s) path's ranks (``workers.split_engine``): every
    rank's output equal to the target's single-process greedy decode
    (``greedy``: each path's, from the first path whose target has one
    rank) and to rank 0's, the same stats on every rank, one host sync of
    the port per round (+1 per chain request), each role's kernels
    launched on each of its ranks, each rank's parameters its own role's
    model's alone (``param_count`` of its shard), and its peak memory above
    what it held before, less those parameters, below the other role's
    weights.  ``backend``: the ranks' process group, gloo's on one card here
    (no speed figure) or NCCL's, one card per rank (``tools/split_nccl.py``).
    Returns the launches per run, summed over the ranks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.parallel.shard import Shard

    _, (tname, n_t), (dname, n_d), runs = SPLIT_PATHS[name]
    cfgs = {"target": get_config(tname), "draft": get_config(dname)}
    label = f"({name}) split {tname} on {n_t} rank{'s' * (n_t > 1)} + {dname} on {n_d}"
    where = (f"{backend}, one card per rank" if backend == "nccl" else
             f"{backend}, {n_t + n_d} ranks on one card: no speed figure")

    def role_bytes(role, i, n):  # rank i of n's shard of the role's model
        c = Shard(cfgs[role], i, n).local_cfg
        return c.param_count() * getattr(torch, c.param_dtype).itemsize

    whole = {role: sum(role_bytes(role, i, n) for i in range(n))
             for role, n in (("target", n_t), ("draft", n_d))}
    if [r["role"] for r in ranks] != ["target"] * n_t + ["draft"] * n_d:
        fail(f"{label}: the ranks' roles are {[r['role'] for r in ranks]}")
    for r in ranks:
        for kname, keys in r["shapes"].items():
            log.seen[kname] |= keys
        role = r["role"]
        other = "draft" if role == "target" else "target"
        want = role_bytes(role, r["ranks"].index(r["rank"]), len(r["ranks"]))
        above = r["peak_allocated"] - r["allocated_before"]
        if r["param_bytes"] != want or r["standin"] != {"is_standin": True, "tensors": 0}:
            fail(f"{label} rank {r['rank']}: {r['param_bytes']} bytes of parameters, its "
                 f"{role}'s shard takes {want}; the {other}'s stand-in {r['standin']}")
        if above - r["param_bytes"] >= whole[other]:
            fail(f"{label} rank {r['rank']}: its peak is {above / 2**30:.2f} GiB above what it "
                 f"held before: beside its {r['param_bytes'] / 2**30:.2f} GiB of weights, room for the "
                 f"{other}'s {whole[other] / 2**30:.2f} GiB")
        print(f"{label} rank {r['rank']} ({role}, ranks {list(r['ranks'])}): parameters "
              f"{r['param_bytes'] / 2**30:.3f} GiB (its {role}'s shard: {want / 2**30:.3f} GiB), "
              f"allocated after the build {r['allocated_after_build'] / 2**30:.3f} GiB, peak "
              f"{r['peak_allocated'] / 2**30:.3f} GiB ({above / 2**30:.3f} GiB above the "
              f"{r['allocated_before'] / 2**30:.3f} GiB held before it; the {other}'s weights: "
              f"{whole[other] / 2**30:.3f} GiB, none here) on {card}", flush=True)
    print(f"{label}: seconds on rank 0: build (the split's groups, the weights drawn) "
          f"{ranks[0]['build_s']:.1f}" + (f", greedy decode {ranks[0]['greedy_s']:.1f}"
                                          if "greedy_s" in ranks[0] else "")
          + "".join(f", {run} {g['wall_s']:.1f} + {g['after_s']:.1f} (its syncs' rounds)"
                    for run, g in ranks[0]["runs"].items()), flush=True)
    if "greedy" in ranks[0]:
        greedy[tname] = ranks[0]["greedy"][0]
    want_toks = greedy[tname]
    counts = {}
    for run, kind in runs:
        per = [r["runs"][run] for r in ranks]
        for r, got in zip(ranks, per):
            toks = got["tokens"][0]
            if toks != want_toks[:len(toks)] or len(toks) != SPLIT_NEW:
                j = next((i for i, (a, b) in enumerate(zip(toks, want_toks)) if a != b),
                         len(toks))
                fail(f"{label} {run} rank {r['rank']}: output diverges from the single-process "
                     f"greedy decode at position {j}")
            if toks != per[0]["tokens"][0] or got["stats"] != per[0]["stats"]:
                fail(f"{label} {run} rank {r['rank']}: tokens or stats differ from rank 0's")
            sy = got["syncs"]
            if sy["syncs"] != sy["rounds"] + sy["requests"]:
                fail(f"{label} {run} rank {r['rank']}: {sy['syncs']} host syncs of the port in "
                     f"{sy['rounds']} rounds of {max(sy['requests'], 1)} request(s), not one per "
                     "round" + (" and one per request" if kind == "chain" else ""))
            missing = [k for k in SPLIT_KERNELS[kind, r["role"]] if got["launches"][k] == 0]
            if missing:
                fail(f"{label} {run} rank {r['rank']} ({r['role']}): kernels never launched: "
                     f"{missing}")
        st, rounds = per[0]["stats"][0], per[0]["rounds"]
        emitted = st["emitted"] if kind == "chain" else sum(st["emitted_rows"])
        sy = per[0]["syncs"]
        counts[f"{name}-{run}"] = {k: sum(g["launches"][k] for g in per) for k in ALL_KERNELS}
        coll = per[0]["collectives"]
        print(f"{label} {run}: {rounds} rounds, compression {emitted / max(rounds, 1):.3f}, mean "
              f"round {per[0]['wall_s'] / max(rounds, 1) * 1e3:.2f} ms ({where}), "
              f"{(sy['syncs'] - sy['requests']) / sy['rounds']:.2f} host syncs of the port per "
              "round"
              + (f" (+{sy['requests']} for the request's first token)" if kind == "chain" else "")
              + f" on every rank, {sum(coll.values()) / max(rounds, 1):.2f} collectives per round "
              f"on rank 0 ({coll}; {coll['broadcast'] / max(rounds, 1):.2f} of them the world's "
              f"exchanges), every rank's output equals the single-process greedy decode, on {card}",
              flush=True)
        for role in ("target", "draft"):
            mine = [(r["rank"], g["launches"]) for r, g in zip(ranks, per) if r["role"] == role]
            print(f"{label} {run}: {role} ranks' kernel launches "
                  f"{[(rk, {k: v for k, v in ln.items() if v}) for rk, ln in mine]}", flush=True)
    return counts


def fleet_requests(vocab: int) -> list:
    """(r)'s trace: FLEET_REQUESTS prompts of 8-16 seeded tokens, one
    arrival every FLEET_GAP virtual seconds (a round is one), so that both
    replicas serve and admissions land beside requests in flight."""
    import numpy as np

    rng = np.random.default_rng(13)
    return [(i, rng.integers(0, vocab, 8 + (3 * i) % 9).astype(np.int32), FLEET_GAP * i,
             FLEET_NEW) for i in range(FLEET_REQUESTS)]


def fleet_job(full_depth: bool = False) -> dict:
    """The ``workers.fleet`` job of (r): FLEET's replicas of its target on
    one rank + its draft on one rank, at full width and FLEET's depths (or
    at full depth), drawn as ``build_engine`` draws them (target seed 0,
    draft seed 1, lm_head x4), lockstep then async rounds on a
    ``VirtualClock``."""
    import dataclasses

    from repro_torch.configs import get_config

    (tname, t_depth), (dname, d_depth), replicas = FLEET
    tcfg, dcfg = get_config(tname), get_config(dname)
    if not full_depth:
        tcfg = dataclasses.replace(tcfg, n_layers=t_depth)
        dcfg = dataclasses.replace(dcfg, n_layers=d_depth)
    tree = dict(bs=8, w=4, c=2, d=2, max_new=FLEET_NEW)
    runs = [(run, {"spec": dict(tree, async_rounds=run == "async"), "slots": FLEET_SLOTS,
                   "requests": fleet_requests(tcfg.vocab_size), "round_dt": 1.0})
            for run in FLEET_RUNS]
    return {"n_target": 1, "n_draft": 1, "replicas": replicas, "tcfg": tcfg, "dcfg": dcfg,
            "weights": ("seed", 0, 1, 4.0), "S_max": 512, "runs": runs, "record_shapes": True}


def fleet_greedy(torch, job) -> dict:
    """rid -> the target's single-process greedy decode of each (r) request
    (the same draws as the ranks'), made on the card before they start."""
    from repro_torch.models.api import make_model

    T = make_model(job["tcfg"], "cuda")
    params = T.init(0)
    params.lm_head.mul_(4.0)
    reqs = job["runs"][0][1]["requests"]
    out = {rid: greedy_decode(torch, T, params, p.reshape(1, -1), n, job["S_max"])[0]
           for rid, p, _, n in reqs}
    del T, params
    torch.cuda.empty_cache()
    return out


def report_fleet(label, job, ranks, greedy, card, log, backend=TP_BACKEND) -> dict:
    """Check and print (r)'s ranks (``workers.fleet``): every request's
    tokens equal to the target's single-process greedy decode (``greedy``),
    every rank's results, replicas and merged summary the same, both
    replicas serving, one host sync of the port per replica round on every
    rank, the split's 2 exchanges per replica round (3 async) on its
    replica's group, one fleet exchange per fleet round, each rank's role
    kernels and slot_write_rows launched, and each rank's parameters its
    own role's model's alone with its peak memory, less them, below the
    other role's weights.  Prints the mean fleet round, each replica's mean
    round and fleet exchange (its ranks' spans), each rank's parameter
    bytes and peak.  Returns the launches per run, summed over the ranks."""
    import math

    import torch

    cfgs = {role: c.param_count() * getattr(torch, c.param_dtype).itemsize
            for role, c in (("target", job["tcfg"]), ("draft", job["dcfg"]))}
    replicas = job["replicas"]
    where = (f"{backend}, one card per rank" if backend == "nccl" else
             f"{backend}, {len(ranks)} ranks on one card: no speed figure")
    if [(r["replica"], r["role"]) for r in ranks] != [(i // 2, ("target", "draft")[i % 2])
                                                      for i in range(2 * replicas)]:
        fail(f"{label}: the ranks' replicas and roles are "
             f"{[(r['replica'], r['role']) for r in ranks]}")
    for r in ranks:
        for kname, keys in r["shapes"].items():
            log.seen[kname] |= keys
        other = "draft" if r["role"] == "target" else "target"
        above = r["peak_allocated"] - r["allocated_before"]
        if r["param_bytes"] != cfgs[r["role"]] or r["standin"] != {"is_standin": True,
                                                                   "tensors": 0}:
            fail(f"{label} rank {r['rank']}: {r['param_bytes']} bytes of parameters, its "
                 f"replica's {r['role']} takes {cfgs[r['role']]}; the stand-in {r['standin']}")
        if above - r["param_bytes"] >= cfgs[other]:
            fail(f"{label} rank {r['rank']}: its peak is {above / 2**30:.2f} GiB above what it "
                 f"held before: room for the {other}'s {cfgs[other] / 2**30:.2f} GiB")
        print(f"{label} rank {r['rank']} (replica {r['replica']} {r['role']}, ranks "
              f"{list(r['replica_ranks'])}): parameters {r['param_bytes'] / 2**30:.3f} GiB (its "
              f"{r['role']} alone; the {other}'s {cfgs[other] / 2**30:.3f} GiB and the other "
              f"replica's are not here), peak {r['peak_allocated'] / 2**30:.3f} GiB "
              f"({above / 2**30:.3f} GiB above the {r['allocated_before'] / 2**30:.3f} GiB held "
              f"before it) on {card}", flush=True)
    counts = {}
    for run in FLEET_RUNS:
        per = [r["runs"][run] for r in ranks]
        first = per[0]
        served = set(first["replica_of"].values())
        if served != set(range(replicas)):
            fail(f"{label} {run}: replicas {sorted(served)} served, not all {replicas}")
        for rid, toks in first["tokens"].items():
            if toks != greedy[rid]:
                j = next((i for i, (a, b) in enumerate(zip(toks, greedy[rid])) if a != b),
                         len(toks))
                fail(f"{label} {run} request {rid}: output diverges from the single-process "
                     f"greedy decode at position {j}")
        if sorted(first["tokens"]) != sorted(greedy):
            fail(f"{label} {run}: requests {sorted(first['tokens'])} finished, not all")

        def same(a, b):
            return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))

        for r, got in zip(ranks, per):
            if (got["tokens"], got["replica_of"], got["spec_stats"]) != (
                    first["tokens"], first["replica_of"], first["spec_stats"]) or not all(
                    same(v, first["summary"][k]) for k, v in got["summary"].items()):
                fail(f"{label} {run} rank {r['rank']}: its results, replicas, stats or summary "
                     "differ from rank 0's")
            sy, own = got["syncs"], got["own_rounds"]
            if sy["syncs"] != own:
                fail(f"{label} {run} rank {r['rank']}: {sy['syncs']} host syncs of the port in "
                     f"its replica's {own} rounds, not one per round")
            per_round = 3 if run == "async" else 2
            if got["collectives"]["broadcast"] != per_round * own:
                fail(f"{label} {run} rank {r['rank']}: {got['collectives']['broadcast']} split "
                     f"exchanges in {own} replica rounds, not {per_round} per round")
            if got["exchanges"] != got["fleet_rounds"]:
                fail(f"{label} {run} rank {r['rank']}: {got['exchanges']} fleet exchanges in "
                     f"{got['fleet_rounds']} fleet rounds, not one per round")
            missing = [k for k in SPLIT_KERNELS["tree", r["role"]] + ("slot_write_rows",)
                       if got["launches"][k] == 0]
            if missing:
                fail(f"{label} {run} rank {r['rank']} ({r['role']}): kernels never launched: "
                     f"{missing}")
        counts[f"r-{run}"] = {k: sum(g["launches"][k] for g in per) for k in ALL_KERNELS}
        reps = collections.defaultdict(list)  # replica -> its ranks' (round, exchange) ms
        for r, g in zip(ranks, per):
            reps[r["replica"]].append((g["round_ms"], g["exchange_ms"], g["own_rounds"]))
        print(f"{label} {run}: {first['fleet_rounds']} fleet rounds, mean fleet round "
              f"{first['wall_s'] / first['fleet_rounds'] * 1e3:.2f} ms (the run's wall on rank 0 "
              "over its fleet rounds, admissions included; "
              + "; ".join(f"replica {i}: {v[0][2]} rounds, mean round to the exchange "
                          f"{max(ms - ex for ms, ex, _ in v):.2f} ms (its slower rank's), its "
                          "ranks' mean wait in the fleet exchange "
                          + " / ".join(f"{ex:.2f}" for _, ex, _ in v) + " ms"
                          for i, v in sorted(reps.items()))
              + f"; {where}), 1.00 host syncs of the port per replica round on every rank, "
              f"{2 + (run == 'async')}.00 split exchanges per replica round on its group, 1 "
              f"fleet exchange per fleet round on the world's gloo group, replicas "
              f"{first['replica_of']}, every request equal to the single-process greedy decode "
              f"and every rank's results, stats and summary equal, on {card}", flush=True)
        print(f"{label} {run}: {first['report'].splitlines()[-1]}", flush=True)
        print(f"{label} {run}: kernel launches summed over the ranks {counts[f'r-{run}']}",
              flush=True)
    return counts


def phase_fleet(torch, card, log) -> dict:
    """(r): router replicas on disjoint rank groups (``workers.fleet``):
    FLEET's two replicas of a split, each a target rank and a draft rank,
    on four ranks that share the card through gloo, serving (r)'s trace
    lockstep then async; checked by ``report_fleet`` against the target's
    single-process greedy decode, made before the ranks start."""
    from repro_torch.configs import get_config
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.spawn import run_ranks

    (tname, t_depth), (dname, d_depth), replicas = FLEET
    label = f"(r) fleet of {replicas} x ({tname}/{t_depth} + {dname}/{d_depth})"
    job = fleet_job()
    print(f"{label}: reduced (depth: target {t_depth} of {get_config(tname).n_layers} layers, "
          f"draft {d_depth} of {get_config(dname).n_layers}, so that two replicas fit the one "
          "card)", flush=True)
    t0 = monotonic()
    greedy = fleet_greedy(torch, job)
    t1 = monotonic()
    ranks = run_ranks("repro_torch.parallel.workers:fleet", 2 * replicas, (job,),
                      workdir=os.path.join(HERE, "build", "fleet"), device="cuda:0",
                      backend=TP_BACKEND, timeout_s=420, threads=2)
    print(f"{label}: greedy reference {t1 - t0:.1f} s; {2 * replicas} ranks started, drew their "
          f"weights and served in {monotonic() - t1:.1f} s (rank 0: build {ranks[0]['build_s']:.1f} "
          "s, " + ", ".join(f"{run} {g['wall_s']:.1f} s" for run, g in ranks[0]["runs"].items())
          + ")", flush=True)
    return report_fleet(label, job, ranks, greedy, card, log)


def phase_shapes(torch, log, card):
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


# -----------------------------------------------------------------------------
# (y) the dry run against the card
# -----------------------------------------------------------------------------

_DRYRUN_PROCS: list = []


DRYRUN_OUT = os.path.join(HERE, "build", "dryrun_smoke")
DRYRUN_MEMORY = os.path.join(DRYRUN_OUT, "memory.json")  # (y2)'s counts on meta


def start_dryrun() -> None:
    """(y1): start the dry run of ``DRYRUN_CELLS`` in one process per
    architecture on the host's CPU (meta tensors: no card, CUDA hidden from
    it), and (y2)'s memory counts (``predict_memory``) in one more, so that
    they run while the card's phases do; ``phase_dryrun`` reads what they
    wrote."""
    import atexit

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), CUDA_VISIBLE_DEVICES="")
    for arch, shapes in DRYRUN_CELLS:
        shape = shapes[0] if len(shapes) == 1 else "all"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "pod1", "--out", DRYRUN_OUT]
        _DRYRUN_PROCS.append((arch, shapes, subprocess.Popen(
            cmd, cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    code = (f"import sys; sys.path[:0] = [{HERE!r}]; import chip_smoke; "
            f"chip_smoke.predict_memory({DRYRUN_MEMORY!r})")
    _DRYRUN_PROCS.append(("(y2) memory", (), subprocess.Popen(
        [sys.executable, "-c", code], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)))
    atexit.register(lambda: [p.kill() for *_, p in _DRYRUN_PROCS if p.poll() is None])


def check_decode_work(torch, model, params, S_max: int, card) -> None:
    """(y2) work: one ``decode_step`` of ``model`` counted by
    ``launch/cost.py`` on the card must equal the same step counted on meta
    — operations, bytes and calls per kernel wrapper, both phases; its
    roofline time (information) printed beside its measured time."""
    from repro_torch.kernels.work import HBM_BYTES_PER_S, PEAK_OPS
    from repro_torch.launch import cost
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.api import make_model

    cfg = model.cfg

    def args(m, p, device):
        cache = m.init_cache(1, S_max)
        cache["len"] = DRYRUN_DECODE_LEN
        return p, cache, torch.zeros((1, 1), dtype=torch.int32, device=device)

    step = make_decode_step(cfg, model, S_max=S_max)
    on_card = args(model, params, "cuda")
    got, _ = cost.count(step, *on_card)
    meta_model = make_model(cfg, "meta")
    want, _ = cost.count(make_decode_step(cfg, meta_model, S_max=S_max),
                         *args(meta_model, meta_model.init(0), "meta"))
    if got.work() != want.work():
        fail(f"(y2) work: {cfg.name} decode_step counted on the card {got.work()} differs from "
             f"the count on meta {want.work()}")
    times = []
    for _ in range(5):
        s0, e0 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        step(*on_card)
        e0.record()
        e0.synchronize()
        times.append(s0.elapsed_time(e0))
    t_roof = max(got.total_flops / PEAK_OPS[str(params.embed.dtype)],
                 got.total_bytes / HBM_BYTES_PER_S) * 1e3
    print(f"(y2) work: {cfg.name} decode_step (B 1, cache {DRYRUN_DECODE_LEN} of {S_max} rows, "
          f"f32) counted on the card = on meta: {got.total_flops:.6e} operations, "
          f"{got.total_bytes:.6e} bytes, calls {got.calls}; roofline {t_roof:.4f} ms "
          f"(H100 SXM data sheet) beside a measured {sorted(times)[2]:.4f} ms (median of 5, "
          f"CUDA events) on {card}", flush=True)


def _train_placed(torch, device, B=TRAIN_B, S=TRAIN_S):
    """Phase (t)'s llama3-1b model, weights, AdamW state and a B x S batch
    on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import make_model
    from repro_torch.optim import adamw_init

    model = make_model(get_config("llama3-1b"), device)
    params = model.init(0, trainable=True)
    batch = {"tokens": torch.zeros((B, S + 1), dtype=torch.int32, device=device)}
    return model, params, adamw_init(params), batch


def predict_memory(path: str) -> None:
    """(y2)'s counts on meta, written to ``path``: phase (t)'s llama3-1b
    train step at each of ``DRYRUN_MEMORY_SHAPES`` counted by
    ``launch/cost.py`` with each ``remat`` — the
    arguments, the bytes live when the backward starts (what the forward
    saved for it), the peak up to the backward's end and the whole step's
    peak.  Runs in a process of its own, with no card."""
    import torch

    from repro_torch.launch import cost
    from repro_torch.launch.steps import make_train_step

    out = {}
    for B, S in DRYRUN_MEMORY_SHAPES:
        for remat in ("none", "full"):
            model, params, opt, batch = _train_placed(torch, "meta", B, S)
            c, _ = cost.count(make_train_step(model.cfg, model, remat=remat), params, opt, batch)
            out.setdefault(f"{B}x{S}", {})[remat] = {
                "args": c.argument_bytes, "saved": c.live_at_backward,
                "fwd+bwd": c.peak_to_backward_end, "step": c.peak_bytes}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)


def _dryrun_memory(torch, B: int, S: int, remat: str, want: dict, card) -> dict:
    """(y2) memory of phase (t)'s llama3-1b train step at B x S with
    ``remat``: the dry run's counts on meta (``predict_memory``'s ``want``)
    against the card's allocator.  -> {what: (counted, card)}."""
    import gc

    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.common import cross_entropy_loss

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, params, opt, batch = _train_placed(torch, "cuda", B, S)
    cfg = model.cfg
    torch.cuda.synchronize()
    got = {"args": torch.cuda.memory_allocated() - base}
    tokens = batch["tokens"]
    loss = cross_entropy_loss(model.forward_train(params, tokens=tokens[:, :-1], remat=remat),
                              tokens[:, 1:])
    torch.cuda.synchronize()
    got["saved"] = torch.cuda.memory_allocated() - base
    del loss
    step = make_train_step(cfg, model, remat=remat)
    for what, run in (("fwd+bwd", lambda: loss_and_grads(model, params, batch, remat)),
                      ("step", lambda: step(params, opt, batch))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        got[what] = torch.cuda.max_memory_allocated() - base
        del out
    del model, params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    rec = {what: (want[what], got[what]) for what in ("args", "saved", "fwd+bwd", "step")}
    for what, (w, g) in rec.items():
        tol = DRYRUN_ARG_TOL if what == "args" else DRYRUN_PEAK_TOL
        err = abs(w - g) / g
        print(f"(y2) memory: llama3-1b train B{B} x S{S} f32 remat={remat!r} "
              f"{what}: counted {w / 2**30:.4f} GiB, card {g / 2**30:.4f} GiB "
              f"({err * 100:.2f} %, tolerance {tol * 100:.0f} %) on {card}", flush=True)
        if err > tol:
            fail(f"(y2) memory: remat={remat!r} {what}: the count {w} bytes is "
                 f"{err * 100:.2f} % from the card's {g} (tolerance {tol * 100:.0f} %)")
    return rec


def check_memory(torch, card) -> None:
    """(y2) memory: ``predict_memory``'s counts against the card's, at each
    of ``DRYRUN_MEMORY_SHAPES``."""
    with open(DRYRUN_MEMORY) as f:
        predicted = json.load(f)
    for (B, S), activations in DRYRUN_MEMORY_SHAPES.items():
        rec = {r: _dryrun_memory(torch, B, S, r, predicted[f"{B}x{S}"][r], card)
               for r in ("none", "full")}
        # remat moves what the forward saves for the backward, and with it the forward +
        # backward peak where the activations set it (else the gradients do, alike)
        for side, i in (("counted", 0), ("card", 1)):
            if not rec["full"]["saved"][i] < rec["none"]["saved"][i]:
                fail(f"(y2) memory B{B} x S{S}: remat='full' does not save less for the "
                     f"backward than 'none' ({side}: {rec['full']['saved'][i]} vs "
                     f"{rec['none']['saved'][i]})")
            full, none = rec["full"]["fwd+bwd"][i], rec["none"]["fwd+bwd"][i]
            if (activations and not full < none) or full > none:
                fail(f"(y2) memory B{B} x S{S}: remat='full''s forward + backward peak is not "
                     f"{'below' if activations else 'at or below'} 'none''s "
                     f"({side}: {full} vs {none})")
        setter = "the activations" if activations else "the gradients"
        print(f"(y2) memory B{B} x S{S}: remat='full' saves less for the backward on both "
              f"sides: counted {rec['none']['saved'][0] / 2**30:.4f} -> "
              f"{rec['full']['saved'][0] / 2**30:.4f} GiB, card "
              f"{rec['none']['saved'][1] / 2**30:.4f} -> {rec['full']['saved'][1] / 2**30:.4f} "
              f"GiB; forward + backward peak ({setter} set it) counted "
              f"{rec['none']['fwd+bwd'][0] / 2**30:.4f} -> "
              f"{rec['full']['fwd+bwd'][0] / 2**30:.4f} GiB, card "
              f"{rec['none']['fwd+bwd'][1] / 2**30:.4f} -> "
              f"{rec['full']['fwd+bwd'][1] / 2**30:.4f} GiB", flush=True)


def phase_dryrun(torch, card) -> None:
    """(y): the dry run's records (y1), its memory against the card's (y2),
    and the static HOTSYNC rule against the runtime sync counter (y3)."""
    for what, shapes, proc in _DRYRUN_PROCS:
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"(y1) the dry run of {what} did not end in 600 s")
        if shapes:
            print("\n".join(f"(y1) {line}" for line in text.strip().splitlines() if line),
                  flush=True)
        if proc.returncode != 0:
            fail(f"(y1) the dry run of {what} exited {proc.returncode}: {text[-2000:]}")
        for shape in shapes:
            with open(os.path.join(DRYRUN_OUT, "pod1", f"{what}__{shape}.json")) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                fail(f"(y1) {what} {shape}: status {rec['status']}")

    check_memory(torch, card)

    from repro_torch.analysis import build_project_context
    from repro_torch.analysis.core import analyze_file

    pkg = os.path.join(HERE, "src", "repro_torch")
    project = build_project_context([pkg])
    if not SYNC_SITES.get("main path (a) 8B+1B"):
        fail("(y3) path (a) recorded no sync site")
    lines = collections.defaultdict(list)  # the port's line -> the paths that synced there
    for label, sites in SYNC_SITES.items():
        for site in sites:
            where = site.split(" via ", 1)[-1].split(" <- ")[0]  # the innermost port frame
            if not where.startswith("src/repro_torch/"):
                fail(f"(y3) {label} synced outside the port's code: {site}")
            lines[where].append(label[label.find("("):label.find(")") + 1] or label)
    for where, labels in sorted(lines.items()):
        path, line = where.rsplit(":", 1)
        found = analyze_file(os.path.join(HERE, path), pkg, project, with_suppressed=True)
        if not any(f.rule == "HOTSYNC" and f.suppressed and f.line == int(line) for f in found):
            fail(f"(y3) {labels} synced at {where}, where the port's HOTSYNC rule reports no "
                 f"suppressed finding")
        print(f"(y3) {where}: a suppressed HOTSYNC line (a designated sync), where "
              f"{len(labels)} path(s) synced: {sorted(set(labels))}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script needs one CUDA GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import ops
    from repro_torch.kernels.shapes import ShapeLog
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

    start_dryrun()
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
    counts.update(phase_train(torch, card))
    timing("train (t)")
    counts.update(phase_train_tp(torch, card, log))
    timing("train tp (t2a)-(t2b)")
    counts.update(phase_tp(torch, card, log))
    timing("tp (p1)-(p3), split (s1)-(s2) and families (q1)-(q4)")
    counts.update(phase_fleet(torch, card, log))
    timing("fleet (r)")
    phase_dryrun(torch, card)
    timing("dryrun (y1)-(y3)")
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
