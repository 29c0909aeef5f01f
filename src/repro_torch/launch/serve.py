"""The port's serving entry point: lockstep speculative decoding end to end.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 3 --max-new 48
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --d 1

Runs the profile pass (paper §5.5: expansion depth d) unless ``--d`` is
given, then decodes a deterministic request stream through SpecEngine and
reports decoding speed and compression ratio per request.  As in the
reference CLI the models are the smoke configs; ``build_engine(...,
smoke=False)`` builds the published widths.  Target and draft share one
device (``--device``, default ``cuda``).  Continuous batching, async rounds
and replicas come with their own slices and are not accepted yet.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import SpecConfig, SpecEngine
from repro_torch.core.scheduler import candidate_depths
from repro_torch.data import make_request_stream
from repro_torch.models.api import make_model
from repro_torch.obs.clock import monotonic


def build_engine(target_arch: str, draft_arch: str, *, smoke=True, mode="parallel",
                 bs=8, w=4, c=2, d=2, max_new=48, S_max=512, peaked=True, device=None):
    """Build the serving engine.  Returns (engine, tparams, dparams, cfgT).

    Weights are the port's own seeded random init, drawn on ``device``
    (target seed 0, draft seed 1); ``peaked`` scales both lm_heads by 4 so
    greedy chains are peaked enough for realistic acceptance."""
    device = resolve_device(device)
    cfgT = get_config(target_arch, smoke=smoke)
    cfgD = get_config(draft_arch, smoke=smoke)
    assert cfgT.vocab_size == cfgD.vocab_size, "draft/target must share a vocab"
    T, D = make_model(cfgT, device), make_model(cfgD, device)
    tp = T.init(0)
    dp = D.init(1)
    if peaked:
        # random-init logits are near-uniform; scale the lm_head so greedy
        # chains are peaked enough for realistic acceptance behaviour
        tp.lm_head.mul_(4.0)
        dp.lm_head.mul_(4.0)
    cfg = SpecConfig(bs=bs, w=w, c=c, d=d, mode=mode, max_new=max_new)
    return SpecEngine(T, D, cfg, S_max_t=S_max, S_max_d=S_max), tp, dp, cfgT


def profile_depth(eng: SpecEngine, tp, dp, prompt_len: int) -> str:
    """Profile pass: set ``eng.cfg.d`` to the lower candidate depth and
    return the report line."""
    prof = eng.profile(tp, dp, np.zeros((1, prompt_len), np.int32))
    d_lo, d_hi = candidate_depths(prof)
    eng.cfg = dataclasses.replace(eng.cfg, d=d_lo)
    return (f"profile: t_draft={prof.t_draft_s*1e3:.1f}ms t_target={prof.t_target_s*1e3:.1f}ms "
            f"-> d in {{{d_lo},{d_hi}}}, using d={d_lo}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target-arch", default="qwen2.5-14b")
    ap.add_argument("--draft-arch", default="qwen2.5-14b")
    ap.add_argument("--mode", choices=["parallel", "serial"], default="parallel")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--w", type=int, default=4)
    ap.add_argument("--d", type=int, default=0, help="0 = profile-derived")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    eng, tp, dp, cfgT = build_engine(
        args.target_arch, args.draft_arch, mode=args.mode, bs=args.bs, w=args.w,
        d=args.d or 2, max_new=args.max_new, device=args.device)
    if args.d == 0:
        print(profile_depth(eng, tp, dp, args.prompt_len))

    total_toks, total_s = 0, 0.0
    sess = eng.session(tp, dp)
    for i, prompt in enumerate(make_request_stream(cfgT.vocab_size, args.prompt_len, 1, args.requests)):
        t0 = monotonic()
        out, stats = sess.generate(prompt)
        dt = monotonic() - t0
        total_toks += len(out[0])
        total_s += dt
        print(f"req {i}: {len(out[0])} tokens in {dt:.2f}s "
              f"({len(out[0])/dt:.1f} tok/s), compression {stats.compression_ratio:.2f}")
    print(f"aggregate: {total_toks/total_s:.1f} tokens/s ({args.mode} mode)")


if __name__ == "__main__":
    main()
