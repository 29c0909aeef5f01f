#!/usr/bin/env python3
"""Time variants of the port's KV row-move kernel on one NVIDIA GPU.

  python3 tools/kv_move_variants.py [--other DIR]

Each variant is this checkout's ``src/repro_torch`` copied into
``build/kv_move_variants/<name>/`` with a textual change to
``kernels/csrc/kv_moves.cu`` (or ``kernels/ops.py``), built by its own
``kernels/build.py`` and timed in a process of its own at ``chip_smoke.py``'s timed shapes
(``KV_TIMED`` at B 1 and 2 under ``kv_plan``/``kv_plan2``), f32 and bf16,
in place and copying through, one leaf and the whole cache (k and v), with
``chip_smoke.Timer`` (CUDA events, L2 flushed, median of 21):

  kernel       the kernel as it is; this run also times the library calls
               (index assignment, after ``clone()`` when copying through)
               and the kernel once more with the L2 flushed by a read, so
               that no dirty line is written back under its reads
  empty        returns at its first instruction: the launch and the timer
  gather-only  the plan compacted and the source segments staged, nothing
               written (its results are wrong): the reads alone
  no-copy      copying through without the slab copy (its results are
               wrong): what the slab costs beside the moves
  registers    16-byte rows through registers instead of bulk copies
  bulk-128     bulk copies for 128-byte segments in place too (the kernel
               moves them through registers)
  ring-4k      the slab copy's ring in stages of 4 KB instead of 8 KB
  ring-16k     ... of 16 KB
  ring-3       ... of 3 stages instead of 4
  chunk-512    512-byte column chunks (``ops._KV_CHUNK``) instead of 256

``--other DIR`` also times the kernel of another checkout (``DIR/src``,
e.g. the parent commit unpacked with ``git archive``), once before the
variants and once after; a checkout without ``kv_move_leaves`` moves the
whole cache with one ``kv_move_rows`` launch per leaf.  Every line carries
the card's name and power limit.  Nothing here is imported by the port.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "kv_move_variants")
CU = os.path.join("repro_torch", "kernels", "csrc", "kv_moves.cu")
OPS = os.path.join("repro_torch", "kernels", "ops.py")
_COPY = "  if (p.copy_through) {\n    const int per"
_NO_COPY = (CU, _COPY, _COPY.replace("(p.copy_through)", "(p.copy_through && p.M < 0)"))

# name -> [(file, anchor, replacement)]
_FIRST = "  constexpr bool kBulkCopy = kBulk && sizeof(E) == 16;\n"
_STORE = "bulk_store(o + (long long)pairs[i].y * F + f0, stage + (size_t)i * pitch, seg);"
VARIANTS = {
    "kernel": [],
    "empty": [(CU, _FIRST, _FIRST + "  if (p.M > 0) return;\n")],
    "gather-only": [(CU, _STORE, _STORE.replace("bulk_store", "if (p.M < 0) bulk_store")),
                    (CU, "      if (col < fc) o[", "      if (col < fc && p.M < 0) o["), _NO_COPY],
    "no-copy": [_NO_COPY],
    "registers": [(CU, "kBulk = true;", "kBulk = false;")],
    "bulk-128": [(CU, "kBulkMoveBytes = 256;", "kBulkMoveBytes = 128;")],
    "ring-4k": [(CU, "kStageBytes = 8192;", "kStageBytes = 4096;")],
    "ring-16k": [(CU, "kStageBytes = 8192;", "kStageBytes = 16384;")],
    "ring-3": [(CU, "kRing = 4;", "kRing = 3;")],
    "chunk-512": [(OPS, "_KV_CHUNK = 256", "_KV_CHUNK = 512")],
}


def make_variant(name: str) -> str:
    """Copy the port into build/kv_move_variants/<name>/src, patched."""
    src = os.path.join(OUT, name, "src")
    shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "src", "repro_torch"), os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, anchor, new in VARIANTS[name]:
        path = os.path.join(src, rel)
        with open(path) as f:
            text = f.read()
        if text.count(anchor) != 1:
            raise SystemExit(f"kv_move_variants: variant {name}: anchor not found once in "
                             f"{rel}: {anchor!r}")
        with open(path, "w") as f:
            f.write(text.replace(anchor, new))
    return src


def child(src: str, name: str) -> None:
    """Build the kernel of ``src`` and print its times."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import build, ops

    if not ops.__file__.startswith(src):
        raise SystemExit(f"kv_move_variants: imported {ops.__file__}, not {src}")
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(("kv_moves",))
    timer, clean = cs.Timer(torch), cs.Timer(torch)
    flush = clean.flush
    clean.flush = types.SimpleNamespace(zero_=flush.max)  # a read leaves clean lines in L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    one_launch = hasattr(ops, "kv_move_leaves")
    S = 512

    def move(leaves, plan, donate):
        if one_launch:
            return lambda: ops.kv_move_leaves(leaves, *plan, donate=donate)
        return lambda: [ops.kv_move_rows(x, *plan, donate=donate) for x in leaves]

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for label, (U, M, Fw) in cs.KV_TIMED:
            for B in (1, 2):
                leaves = [torch.randn((U, B, S, Fw), generator=gen, device="cuda").to(dtype)
                          for _ in range(2)]
                plan = cs.kv_plan(torch, M, n_off=min(M, 3) if M > 8 else 0) if B == 1 \
                    else cs.kv_plan2(torch, M, parked=False)
                for donate in (True, False):
                    for use in (leaves[:1], leaves):
                        what = ("in place" if donate else "copy-through") + \
                            (", k+v" if len(use) == 2 else ", one leaf")
                        ms = timer(move(use, plan, donate))
                        bound = cs.kv_move_bytes(use, *plan, donate) / cs.HBM_BYTES_PER_S * 1e3
                        line = (f"variant {name} kv_move {label} U{U} B{B} S{S} F{Fw} M{M} {dt} "
                                f"{what}: {ms:.4f} ms (bound {bound:.4f})")
                        if name == "kernel":
                            lib = timer(cs.kv_library(use, *plan, donate))
                            line += (f" (library {lib:.4f} ms; kernel after a clean L2 "
                                     f"{clean(move(use, plan, donate)):.4f} ms)")
                        print(f"{line} [{smi}]")
        sys.stdout.flush()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    other = None
    if len(sys.argv) == 3 and sys.argv[1] == "--other":
        other = os.path.abspath(os.path.join(sys.argv[2], "src"))
    elif len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    runs = [(make_variant(name), name) for name in VARIANTS]
    if other:
        runs = [(other, "other")] + runs + [(other, "other")]
    for src, name in runs:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src,
                             name]).returncode
        if rc != 0:
            print(f"kv_move_variants: variant {name} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
