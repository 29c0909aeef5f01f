"""The port's training driver (``repro.launch.train``), on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 60 \\
      --batch 4 --seq 32 --ckpt /tmp/ckpt

Trains a model on the deterministic synthetic Markov stream
(``data.SyntheticLMDataset``) with the functional train step
(``launch.steps.make_train_step``: cross-entropy, autograd, AdamW at the
warmup-cosine rate), each step under ``runtime.retry_step``; with
``--ckpt`` it resumes from the newest valid checkpoint and saves every
``--ckpt-every`` steps (atomic, async) and at the end.  It logs the loss
and prints whether the mean of the last ten losses is below the first
ten's ("improved").  As in the reference CLI the model is the smoke
config; ``train(get_config(arch), ...)`` trains the published widths.
Without ``--device`` it runs on ``cuda``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import make_model
from repro_torch.obs.clock import monotonic
from repro_torch.optim import adamw_init
from repro_torch.runtime import FaultConfig, retry_step


def stub_embeddings(cfg, device, seed: int = 1) -> torch.Tensor:
    """The stub frontend's embedding table [V, d] for a config whose inputs
    are embeddings (``embed_inputs`` false): N(0, 0.02²) from the port's
    own seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device) * 0.02


def make_batch(cfg, host: dict, device, emb: torch.Tensor | None = None) -> dict:
    """A train batch on ``device`` from the dataset's host tokens [B, S+1]:
    the tokens, or for an embeddings-input config the stub embeddings of
    the inputs and the labels; + zero encoder states for cross blocks."""
    toks = torch.as_tensor(host["tokens"], device=device)
    B = toks.shape[0]
    if cfg.embed_inputs:
        batch = {"tokens": toks}
    else:
        batch = {"embeds": emb[toks[:, :-1].long()], "labels": toks[:, 1:]}
    if cfg.n_enc_tokens:
        batch["enc"] = torch.zeros((B, cfg.n_enc_tokens, cfg.d_model), device=device)
    return batch


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128, lr: float = 1e-3,
          warmup_steps: int = 20, ckpt: str = "", ckpt_every: int = 50, log_every: int = 10,
          repeat_batch: bool = False, stop_at: int | None = None, device=None,
          log=print) -> dict:
    """Train ``cfg`` from the seed-0 weights for ``steps`` steps.  Returns
    {"losses", "first", "last", "params", "opt", "start", "step_s"}: the
    loss of every step run, the means of the first and last ten, the final
    state, the step it resumed from and each step's seconds (host clock,
    the loss's transfer included).  ``repeat_batch`` trains on step 0's
    batch at every step (a loss that must fall).  ``stop_at`` ends the run
    before that step as a preemption would — no final checkpoint, the
    schedule still the one of ``steps`` — so a later run resumes from the
    last periodic checkpoint."""
    device = resolve_device(device)
    model = make_model(cfg, device)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    step_fn = make_train_step(cfg, model, peak_lr=lr, warmup_steps=warmup_steps,
                              total_steps=steps)
    emb = None if cfg.embed_inputs else stub_embeddings(cfg, device)
    params = model.init(0, trainable=True)
    opt = adamw_init(params)
    start, cm = 0, None
    if ckpt:
        cm = CheckpointManager(ckpt, keep=2)
        s, restored = cm.restore_latest((params, opt))
        if s is not None:
            start, (params, opt) = s + 1, restored
            log(f"resumed from step {s}")
    losses, step_s = [], []
    t0 = monotonic()
    for step in range(start, steps if stop_at is None else min(stop_at, steps)):
        feed = make_batch(cfg, ds.batch(0 if repeat_batch else step), device, emb)
        ts = monotonic()
        params, opt, loss = retry_step(lambda: step_fn(params, opt, feed), FaultConfig())
        losses.append(float(loss))
        step_s.append(monotonic() - ts)
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step:5d} loss {losses[-1]:.4f} ({monotonic() - t0:.1f}s)")
        if cm and step and step % ckpt_every == 0:
            cm.save(step, (params, opt))
    if cm and stop_at is not None and stop_at < steps:
        cm.wait()  # the last periodic save reaches the disk; no final one
    elif cm:
        cm.save(steps - 1, (params, opt), blocking=True)
    first = float(np.mean(losses[:10])) if losses else float("nan")
    last = float(np.mean(losses[-10:])) if losses else float("nan")
    return {"losses": losses, "first": first, "last": last, "params": params, "opt": opt,
            "start": start, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    out = train(get_config(args.arch, smoke=args.smoke), steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                log_every=args.log_every, device=args.device)
    first, last = out["first"], out["last"]
    print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")
    return first, last


if __name__ == "__main__":
    main()
