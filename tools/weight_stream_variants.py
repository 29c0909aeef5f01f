#!/usr/bin/env python3
"""Time variants of the port's weight-stream kernels on one NVIDIA GPU.

  python3 tools/weight_stream_variants.py [--other DIR]

fused_swiglu and int4_matmul share one kernel template,
``kernels/csrc/weight_stream.cuh``.  Each variant is this checkout's
``src/repro_torch`` copied into ``build/weight_stream_variants/<name>/`` with
one textual change to that header, built by its own ``kernels/build.py`` and
timed in a process of its own at ``chip_smoke.py``'s timed shapes
(``SWIGLU_TIMED`` of ``SWIGLU_SHAPES``; ``INT4_TIMED`` at M 1 and 8, group
``AWQ_GROUP``), f32 and bf16, with ``chip_smoke.Timer`` (CUDA events, L2
flushed, median of 21):

  kernel      the kernels as they are; this run also times the yardsticks
              (fused_swiglu's composite silu(x @ wg) * (x @ wu), torch's
              _weight_int4pack_mm for int4 in bf16)
  empty       returns at its first instruction: the launch and the timer
  loads-only  the ring fills and drains, x is staged and the results are
              written, but no stage is computed: the bytes alone
  no-combine  the split partials are written and the tickets taken, but the
              last block does not add them (its results are wrong): what
              the in-kernel combine costs

``--other DIR`` also times the kernels of another checkout (``DIR/src``,
e.g. the parent commit unpacked with ``git archive``), once before the
variants and once after.  Every line carries the card's name and power
limit.  Nothing here is imported by the port.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "weight_stream_variants")
CUH = os.path.join("repro_torch", "kernels", "csrc", "weight_stream.cuh")

# name -> [(anchor, replacement)] in weight_stream.cuh
VARIANTS = {
    "kernel": [],
    "empty": [("  Op op(a, smem);\n", "  if (a.sp.K > 0) return;\n  Op op(a, smem);\n")],
    "loads-only": [("    op.compute(it, it % S);\n", "")],
    "no-combine": [("  if (!__syncthreads_or(last)) return;\n",
                    "  if (!__syncthreads_or(last) || sp.K > 0) return;\n")],
}


def make_variant(name: str) -> str:
    """Copy the port into build/weight_stream_variants/<name>/src, patched."""
    src = os.path.join(OUT, name, "src")
    shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "src", "repro_torch"), os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(src, CUH)
    with open(path) as f:
        text = f.read()
    for anchor, new in VARIANTS[name]:
        if text.count(anchor) != 1:
            raise SystemExit(f"weight_stream_variants: variant {name}: anchor not found once: "
                             f"{anchor!r}")
        text = text.replace(anchor, new)
    with open(path, "w") as f:
        f.write(text)
    return src


def child(src: str, name: str) -> None:
    """Build the two kernels of ``src`` and print their times."""
    sys.path.insert(0, src)
    import torch

    from repro_torch import quant
    from repro_torch.kernels import build, ops

    if not ops.__file__.startswith(src):
        raise SystemExit(f"weight_stream_variants: imported {ops.__file__}, not {src}")
    sys.path.insert(1, HERE)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(("fused_swiglu", "int4_matmul"))
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    yardsticks = name == "kernel"

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    shapes = dict(cs.SWIGLU_SHAPES)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for label in cs.SWIGLU_TIMED:
            M, K, N = shapes[label]
            x = randn(M, K, dtype=dtype)
            wg, wu = (randn(K, N, dtype=dtype, scale=K ** -0.5) for _ in range(2))
            ms = timer(lambda: ops.fused_swiglu(x, wg, wu))
            line = f"variant {name} fused_swiglu {label} M{M} K{K} N{N} {dt}: {ms:.4f} ms"
            if yardsticks:
                lib = timer(lambda: torch.nn.functional.silu(x @ wg) * (x @ wu))
                line += f" (composite {lib:.4f} ms)"
            print(f"{line} [{smi}]")
        for label, K, N in cs.INT4_TIMED:
            q = quant.quantize_groupwise(randn(K, N, scale=K ** -0.5), cs.AWQ_GROUP)
            for M in (1, 8):
                x = randn(M, K, dtype=dtype)
                ms = timer(lambda: ops.int4_matmul(x, *q[:3], group_size=cs.AWQ_GROUP))
                line = (f"variant {name} int4_matmul {label} M{M} K{K} N{N} g{cs.AWQ_GROUP} {dt}: "
                        f"{ms:.4f} ms")
                if yardsticks:
                    library, note = cs.int4pack_library(torch, x, q)
                    line += f" (_weight_int4pack_mm {timer(library):.4f} ms)" if library else \
                        f" {note}"
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
            print(f"weight_stream_variants: variant {name} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
