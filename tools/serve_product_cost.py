#!/usr/bin/env python3
"""What the serving product costs a forward on one card: host time per call, and the step.

  python3 tools/serve_product_cost.py        # needs one NVIDIA GPU

The serving forward's dense products go through ``ops.stream_matmul``
(``models.common.project``), a hand-written kernel whose sum over K does
not depend on the rows, in place of ``torch.matmul`` (cuBLAS), whose sums
do.  The serving rounds are host-bound, so the wrapper's host time counts
as much as the kernel's device time.  This script measures, on llama3-8b's
shapes:

1. host time per call: 400 calls enqueued back to back without a sync
   (after a warm-up), the host clock over them divided by 400, for
   ``ops.stream_matmul``, ``torch.matmul``, ``ops.fused_swiglu``,
   ``ops.tree_attention`` and ``ops.decode_attention`` at a decode step's
   and a verify's shapes, f32 and bf16;
2. the step: llama3-8b at full depth (seeded draws, f32, and the same
   rounded to bf16) — a ``decode_step`` at a cache of 48 rows, a 16-token
   ``prefill`` (the serving paths' prompts: the time to first token) and a
   512-token ``prefill`` (a long prompt: every product in the kernel's fat
   regime) — with ``project`` as the port runs it and with ``project``
   replaced by ``x @ w`` (cuBLAS: the yardstick, no part of the port), in
   turns port, cuBLAS, cuBLAS, port, each the median of 7 (host clock
   around the call and a synchronize).

Exit 0 when it ran; what it found is printed, not judged.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

CALLS = 400
REPS = 7
LONG_PROMPT = 512  # a long prompt's rows: the products' fat regime


def host_us(torch, fn) -> float:
    """Host microseconds per call of ``fn``, enqueued back to back."""
    from repro_torch.obs.clock import monotonic

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = monotonic()
    for _ in range(CALLS):
        fn()
    t = monotonic() - t0
    torch.cuda.synchronize()
    return t / CALLS * 1e6


def check_host(torch, card) -> None:
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    S, PREFIX = 512, 48
    for dtype in (torch.float32, torch.bfloat16):
        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

        wq, wg, wu = randn(4096, 4096, scale=1 / 64), randn(4096, 14336, scale=1 / 64), \
            randn(4096, 14336, scale=1 / 64)
        k, v = randn(1, S, 8, 128), randn(1, S, 8, 128)
        mask = torch.zeros((1, 8, S), dtype=torch.bool, device="cuda")
        mask[..., :PREFIX + 8] = True
        for M in (1, 8):
            x = randn(M, 4096)
            q = randn(1, M, 32, 128)
            row = {"stream_matmul": host_us(torch, lambda: ops.stream_matmul(x, wq)),
                   "torch.matmul": host_us(torch, lambda: torch.matmul(x, wq)),
                   "fused_swiglu": host_us(torch, lambda: ops.fused_swiglu(x, wg, wu)),
                   "tree_attention": host_us(torch, lambda: ops.tree_attention(
                       q, k, v, mask[:, :M]))}
            if M == 1:
                row["decode_attention"] = host_us(
                    torch, lambda: ops.decode_attention(q[:, 0], k, v, PREFIX))
            print(f"host: {str(dtype).removeprefix('torch.')} M {M} (8B wq, MLP, attention "
                  "S 512): " + ", ".join(f"{name} {us:.1f} us" for name, us in row.items())
                  + f" a call, enqueued back to back on {card}", flush=True)


def check_step(torch, card) -> None:
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import make_request_stream
    from repro_torch.models import attention, transformer
    from repro_torch.models.api import make_model
    from repro_torch.obs.clock import monotonic

    m32 = make_model(get_config("llama3-8b"), "cuda")
    p32 = chip_smoke.peaked(m32.init(0))
    m16 = make_model(chip_smoke.bf16_config("llama3-8b"), "cuda")
    p16 = chip_smoke.bf16_params(torch, p32)
    prompt = list(make_request_stream(m32.cfg.vocab_size, 16, 1, 1))[0]
    long_prompt = list(make_request_stream(m32.cfg.vocab_size, LONG_PROMPT, 1, 1))[0]
    routed = {mod: mod.project for mod in (attention, transformer)}

    def use(cublas: bool):
        for mod, fn in routed.items():
            mod.project = (lambda x, w: x @ w) if cublas else fn

    def timed(fn) -> float:
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = monotonic()
            fn()
            torch.cuda.synchronize()
            times.append((monotonic() - t0) * 1e3)
        return statistics.median(times)

    try:
        with torch.no_grad():
            for label, model, params in (("f32", m32, p32), ("bf16", m16, p16)):
                _, cache = model.prefill(params, prompt, S_max=512)
                tok = prompt[:, :1]
                res = {"port": [], "cuBLAS": []}
                for who in ("port", "cuBLAS", "cuBLAS", "port"):
                    use(who == "cuBLAS")
                    dec = timed(lambda: model.decode_step(params, dict(cache, len=48), tok, 512))
                    pre = timed(lambda: model.prefill(params, prompt, S_max=512))
                    long = timed(lambda: model.prefill(params, long_prompt, S_max=2 * LONG_PROMPT))
                    res[who].append((dec, pre, long))
                use(False)
                print(f"step: llama3-8b {label} (32 layers), decode_step at 48 cached rows / "
                      f"prefill of 16 tokens / prefill of {LONG_PROMPT} tokens, median of 7 ms, "
                      "in turns port, cuBLAS, cuBLAS, port: " + "; ".join(
                          f"{who} " + ", ".join(f"{d:.2f} / {p:.2f} / {q:.2f}" for d, p, q in runs)
                          for who, runs in res.items()) + f" on {card}", flush=True)
    finally:
        use(False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("serve_product_cost: needs a CUDA device")
    from repro_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi, flush=True)
    print(f"kernels built in {build_all():.1f} s", flush=True)
    with torch.no_grad():
        check_host(torch, card)
    check_step(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
