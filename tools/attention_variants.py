#!/usr/bin/env python3
"""Time variants of the port's attention kernel on one NVIDIA GPU.

  python3 tools/attention_variants.py [--other DIR]

Each variant is this checkout's ``src/repro_torch`` copied into
``build/attention_variants/<name>/`` with one textual change to
``kernels/csrc/attention.cuh``, built by its own ``kernels/build.py`` and
timed in a process of its own at ``chip_smoke.py``'s timed shapes
(``DECODE_TIMED`` at length ``PREFIX``; ``TREE_TIMED`` under a mask of
``PREFIX`` rows plus the tree rows, without and with ``kv_bound``), with
``chip_smoke.Timer`` (CUDA events, L2 flushed, median of 21):

  kernel      the kernel as it is
  empty       returns at its first instruction: the launch and the timer
  no-arith    loads, waits, merges and writes, skips every tile's arithmetic
  spread16    16-key splits with the cross-split combine removed (its
              results are wrong): what spreading a KV head's keys over four
              times the SMs gains before any merge is paid for
  combine16   16-key splits, the whole kernel
  combine32   32-key splits, the whole kernel

``--other DIR`` also times the kernels of another checkout (``DIR/src``),
once before the variants and once after.  Every line carries the card's
name and power limit.  Nothing here is imported by the port.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "attention_variants")
CUH = os.path.join("repro_torch", "kernels", "csrc", "attention.cuh")

# name -> ([(anchor, replacement)], keys per split or None)
_NO_ARITH = "    if constexpr (!kF32) {\n      // ---- bf16: S = Q K^T"
_ANY_SPLIT = ("  if (a.split_keys % 64 != 0 ||", "  if (a.split_keys % 16 != 0 ||")
VARIANTS = {
    "kernel": ([], None),
    "empty": ([("  const int hd = a.hd;\n", "  if (a.scale > 0.f) return;\n  const int hd = a.hd;\n")],
              None),
    "no-arith": ([(_NO_ARITH, "    if (a.scale > 0.f) {\n      __syncthreads();\n      continue;\n"
                   "    }\n" + _NO_ARITH)], None),
    "spread16": ([_ANY_SPLIT, ("  if (a.n_launch == 1) return;\n", "  return;\n")], 16),
    "combine16": ([_ANY_SPLIT], 16),
    "combine32": ([_ANY_SPLIT], 32),
}


def make_variant(name: str) -> str:
    """Copy the port into build/attention_variants/<name>/src, patched."""
    edits, _ = VARIANTS[name]
    src = os.path.join(OUT, name, "src")
    shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "src", "repro_torch"), os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(src, CUH)
    with open(path) as f:
        text = f.read()
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise SystemExit(f"attention_variants: variant {name}: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    with open(path, "w") as f:
        f.write(text)
    return src


def child(src: str, name: str, split: int | None) -> None:
    """Build the kernels of ``src`` and print their times."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import build, ops

    if not ops.__file__.startswith(src):
        raise SystemExit(f"attention_variants: imported {ops.__file__}, not {src}")
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(("tree_attention", "decode_attention"))
    if split is not None:
        ops.attn_split_keys = lambda S: split
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bounded = "kv_bound" in ops.tree_attention.__code__.co_varnames
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for label, (B, hq, hkv, hd, S) in cs.DECODE_TIMED:
            q, k, v = (randn(B, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype),
                       randn(B, S, hkv, hd, dtype=dtype))
            ms = timer(lambda: ops.decode_attention(q, k, v, cs.PREFIX))
            print(f"variant {name} decode_attention {label} L{cs.PREFIX} {dt}: {ms:.4f} ms [{smi}]")
        for label, (B, n, hq, hkv, hd, S) in cs.TREE_TIMED:
            q, k, v = (randn(B, n, hq, hd, dtype=dtype), randn(B, S, hkv, hd, dtype=dtype),
                       randn(B, S, hkv, hd, dtype=dtype))
            mask = torch.zeros((B, n, S), dtype=torch.bool, device="cuda")
            mask[:, :, :cs.PREFIX + n] = True
            ms = timer(lambda: ops.tree_attention(q, k, v, mask))
            print(f"variant {name} tree_attention {label} {dt}: {ms:.4f} ms [{smi}]")
            if bounded:
                ms = timer(lambda: ops.tree_attention(q, k, v, mask, kv_bound=cs.PREFIX + n))
                print(f"variant {name} tree_attention {label} kv_bound {cs.PREFIX + n} {dt}: "
                      f"{ms:.4f} ms [{smi}]")
        sys.stdout.flush()


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3], int(sys.argv[4]) if len(sys.argv) > 4 else None)
        return 0
    other = None
    if len(sys.argv) == 3 and sys.argv[1] == "--other":
        other = os.path.abspath(os.path.join(sys.argv[2], "src"))
    elif len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    runs = [(make_variant(name), name, split) for name, (_, split) in VARIANTS.items()]
    if other:
        runs = [(other, "other", None)] + runs + [(other, "other", None)]
    for src, name, split in runs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", src, name]
        if split is not None:
            cmd.append(str(split))
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            print(f"attention_variants: variant {name} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
