#!/usr/bin/env python3
"""Time variants of the serving product's kernel on one NVIDIA GPU.

  python3 tools/stream_matmul_variants.py [--other DIR]
  python3 tools/stream_matmul_variants.py --plans

Each variant is this checkout's ``src/repro_torch`` copied into
``build/stream_matmul_variants/<name>/`` with textual changes to
``kernels/csrc/stream_matmul.cu``, built by its own ``kernels/build.py``
(all variants at once) and timed in a process of its own with
``chip_smoke.Timer`` (CUDA events, L2 flushed, median of 21) at the bf16
products of llama3-8b and of llama3-70b's tp-4 rank 0 (``chip_smoke``'s
``matmul_shapes``), M 1 and 16 (the skinny regime) and 512 (the fat one):

  kernel      the kernel as it is; this run also times torch.matmul (cuBLAS)
  empty       the bf16 kernel returns at its first instruction: the launch,
              the cluster's scheduling and the timer
  loads-only  the ring fills and drains, but no wgmma is issued (the results
              are wrong): the bytes alone
  no-combine  the skinny regime's splits are not added in the cluster (the
              results are wrong): what the combine through distributed shared
              memory costs

``--plans`` times instead this checkout's kernel under other plans than
``ops.matmul_plan``'s (column tile T and splits S, each a valid plan of the
kernel: the order of summation changes with the plan, the rows' invariance
does not) at the same products, M 1 and 16, beside torch.matmul: one wave
of one CTA an SM against two CTAs an SM with half the K each.

``--other DIR`` also times the kernel of another checkout (``DIR/src``,
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
OUT = os.path.join(HERE, "build", "stream_matmul_variants")
CU = os.path.join("repro_torch", "kernels", "csrc", "stream_matmul.cu")
ROWS = (1, 16, 512)
CONFIGS = ("8B", "70B-tp4-r0")

# name -> [(anchor, replacement)] in stream_matmul.cu
VARIANTS = {
    "kernel": [],
    "empty": [("  using L = Bf16Tile<T, RW, STAGES>;\n",
               "  if (p.K > 0) return;\n  using L = Bf16Tile<T, RW, STAGES>;\n")],
    "loads-only": [("            wgmma_bf16(acc, sw128_desc(a + 32 * t, 1, 64),",
                    "            if (p.K < 0) wgmma_bf16(acc, sw128_desc(a + 32 * t, 1, 64),")],
    "no-combine": [("  if (SKINNY && p.splits > 1)\n    cluster_combine(",
                    "  if (SKINNY && p.splits > 1 && p.K < 0)\n    cluster_combine(")],
}


def make_variant(name: str) -> str:
    """Copy the port into build/stream_matmul_variants/<name>/src, patched."""
    src = os.path.join(OUT, name, "src")
    shutil.rmtree(os.path.join(OUT, name), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "src", "repro_torch"), os.path.join(src, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(src, CU)
    with open(path) as f:
        text = f.read()
    for anchor, new in VARIANTS[name]:
        if text.count(anchor) != 1:
            raise SystemExit(f"stream_matmul_variants: variant {name}: anchor not found once: "
                             f"{anchor!r}")
        text = text.replace(anchor, new)
    with open(path, "w") as f:
        f.write(text)
    return src


def import_port(src: str):
    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops

    if not ops.__file__.startswith(src):
        raise SystemExit(f"stream_matmul_variants: imported {ops.__file__}, not {src}")
    return build, ops


def child(src: str, name: str) -> None:
    """Time the bf16 kernel of ``src``."""
    build, ops = import_port(src)
    import torch

    sys.path.insert(1, HERE)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(("stream_matmul",))
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.bfloat16
    for label, K, N in cs.matmul_shapes():
        if label.rsplit("-", 1)[0] not in CONFIGS:
            continue
        w = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5).to(dtype)
        for M in ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            ms = timer(lambda: ops.stream_matmul(x, w))
            line = f"variant {name} stream_matmul {label} M{M} K{K} N{N} bfloat16: {ms:.4f} ms"
            if name == "kernel":
                line += f" (torch.matmul {timer(lambda: torch.matmul(x, w)):.4f} ms)"
            print(f"{line} [{smi}]", flush=True)


PLANS = ((128, 8), (128, 4), (128, 2), (64, 8), (64, 4), (64, 2))  # (T, S) of --plans


def plans() -> None:
    """Time the bf16 kernel under each plan of PLANS that cuts K into S
    splits of whole 64-value quanta."""
    build, ops = import_port(os.path.join(HERE, "src"))
    import torch

    sys.path.insert(1, HERE)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all(("stream_matmul",))
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    own = ops.matmul_plan
    for label, K, N in cs.matmul_shapes():
        if label.rsplit("-", 1)[0] not in CONFIGS or label.endswith("lm_head"):
            continue
        w = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16)
        xs = {M: torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
              for M in (1, 16)}
        lib = [timer(lambda: torch.matmul(xs[M], w)) for M in (1, 16)]
        cols = [f"torch.matmul {lib[0]:.4f} / {lib[1]:.4f}",
                f"own plan {own(K, N, torch.bfloat16)}"]
        for T, S in PLANS:
            quanta = -(-K // 64)
            per = -(-quanta // S)
            if -(-quanta // per) != S:
                continue
            ops.matmul_plan = lambda K_, N_, dt_, T=T, per=per, S=S: (T, per * 64, S)
            try:
                t1, t16 = (timer(lambda: ops.stream_matmul(xs[M], w)) for M in (1, 16))
            finally:
                ops.matmul_plan = own
            cols.append(f"T {T} S {S} ({-(-N // T) * S} CTAs) {t1:.4f} / {t16:.4f}")
        print(f"plans stream_matmul {label} K{K} N{N} bfloat16, M 1 / 16 ms: " + "; ".join(cols)
              + f" [{smi}]", flush=True)


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--plans":
        plans()
        return 0
    if len(sys.argv) == 4 and sys.argv[1] in ("--child", "--build"):
        if sys.argv[1] == "--build":
            import_port(sys.argv[2])[0].build_all(("stream_matmul",))
        else:
            child(sys.argv[2], sys.argv[3])
        return 0
    other = None
    if len(sys.argv) == 3 and sys.argv[1] == "--other":
        other = os.path.abspath(os.path.join(sys.argv[2], "src"))
    elif len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    runs = [(make_variant(name), name) for name in VARIANTS]
    builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", src, name])
              for src, name in runs]  # every variant's nvcc at once
    if any(b.wait() != 0 for b in builds):
        print("stream_matmul_variants: a variant's build failed", file=sys.stderr)
        return 1
    if other:
        runs = [(other, "other")] + runs + [(other, "other")]
    for src, name in runs:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src,
                             name]).returncode
        if rc != 0:
            print(f"stream_matmul_variants: variant {name} exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
