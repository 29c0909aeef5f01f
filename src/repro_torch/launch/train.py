"""The port's training driver (``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 60 \\
      --batch 4 --seq 32 --ckpt /tmp/ckpt
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --device cpu --mesh-model 2 --steps 6 --ckpt /tmp/ckpt

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

Under torchrun (``RANK`` set) every rank joins the world and
``--mesh-model`` (default 1) carves it as the reference's ("data",
"model") mesh (``launch.mesh.make_train_ranks``): each run of
``--mesh-model`` consecutive ranks holds the model sharded over it, and the
ranks that share a model index split the global batch of ``--batch`` rows
between them and average their gradients.  Each model rank checkpoints its
own state (``ckpt.manager.rank_dir``), written by its first data rank; a
resume agrees on the step over the world.  A fault is retried on one rank
only in a single process: under a world it is raised (a retry on one rank
alone would leave the others waiting in a collective), the other ranks'
next collective fails, and the job resumes from its last checkpoint.  Only
rank 0 logs, and the process group is torn down on every path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.manager import check_layout, rank_dir
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset, sharded_batches
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


def _agreed_step(world, step):
    """The newest checkpoint step that every rank of ``world`` holds (None:
    none), from each rank's newest ``step``."""
    if world is None or world.world == 1:
        return step
    mine = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=world.device)
    low = int(world.all_gather(mine, dim=0).min())
    return None if low < 0 else low


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128, lr: float = 1e-3,
          warmup_steps: int = 20, ckpt: str = "", ckpt_every: int = 50, log_every: int = 10,
          repeat_batch: bool = False, stop_at: int | None = None, device=None,
          world=None, mesh_model: int = 1, log=print) -> dict:
    """Train ``cfg`` from the seed-0 weights for ``steps`` steps.  Returns
    {"losses", "first", "last", "params", "opt", "start", "step_s"}: the
    loss of every step run, the means of the first and last ten, the final
    state, the step it resumed from and each step's seconds (host clock,
    the loss's transfer included).  ``repeat_batch`` trains on step 0's
    batch at every step (a loss that must fall).  ``stop_at`` ends the run
    before that step as a preemption would — no final checkpoint, the
    schedule still the one of ``steps`` — so a later run resumes from the
    last periodic checkpoint.

    ``world``: a joined process group of several ranks (``parallel.init_tp``;
    its device is the run's), carved by ``mesh_model``
    (``parallel.group.make_train_groups``): this rank's model is the seed-0
    weights sharded over its model group (``Model.init`` pads and slices
    each tensor as it is drawn, as ``parallel.shard_params`` does), it
    trains on its data rank's rows of each global batch of ``batch`` rows,
    and the losses are the global batch's, the same on every rank; the
    state returned is this rank's."""
    from repro_torch.parallel.group import make_train_groups

    group = data = None
    layout = (1, 1)
    if world is not None and world.world > 1:
        group, data = make_train_groups(world, mesh_model)
        layout, device = (world.world, mesh_model), world.device
    elif mesh_model != 1:
        raise ValueError(f"--mesh-model {mesh_model} needs a world of several ranks (torchrun)")
    device = resolve_device(device)
    if world is not None and world.rank != 0:
        log = _quiet
    model = make_model(cfg, device, group if group is not None and group.world > 1 else None)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    step_fn = make_train_step(cfg, model, peak_lr=lr, warmup_steps=warmup_steps,
                              total_steps=steps, data=data)
    emb = None if cfg.embed_inputs else stub_embeddings(cfg, device)
    params = model.init(0, trainable=True)
    opt = adamw_init(params)
    start, cm = 0, None
    writer = data is None or data.rank == 0  # the first data rank writes its model rank's state
    if ckpt:
        os.makedirs(ckpt, exist_ok=True)
        check_layout(ckpt, layout, write=writer)
        cm = CheckpointManager(rank_dir(ckpt, layout, 0 if group is None else group.rank), keep=2)
        s, restored = cm.restore_latest((params, opt))
        agreed = _agreed_step(world, s)
        if agreed is not None and agreed != s:
            restored = cm.restore(agreed, (params, opt))
        if agreed is not None:
            start, (params, opt) = agreed + 1, restored
            log(f"resumed from step {agreed}")
    fault = FaultConfig() if world is None or world.world == 1 else FaultConfig(max_retries=0)
    losses, step_s = [], []
    t0 = monotonic()
    for step in range(start, steps if stop_at is None else min(stop_at, steps)):
        src = 0 if repeat_batch else step
        host = ds.batch(src) if data is None else next(sharded_batches(ds, data, src))
        feed = make_batch(cfg, host, device, emb)
        ts = monotonic()
        params, opt, loss = retry_step(lambda: step_fn(params, opt, feed), fault)
        losses.append(float(loss))
        step_s.append(monotonic() - ts)
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step:5d} loss {losses[-1]:.4f} ({monotonic() - t0:.1f}s)")
        if cm and writer and step and step % ckpt_every == 0:
            cm.save(step, (params, opt))
    if cm and stop_at is not None and stop_at < steps:
        cm.wait()  # the last periodic save reaches the disk; no final one
    elif cm and writer:
        cm.save(steps - 1, (params, opt), blocking=True)
    if world is not None and world.world > 1:  # every rank's checkpoints are on disk
        world.all_reduce(torch.zeros(1, device=device))
    first = float(np.mean(losses[:10])) if losses else float("nan")
    last = float(np.mean(losses[-10:])) if losses else float("nan")
    return {"losses": losses, "first": first, "last": last, "params": params, "opt": opt,
            "start": start, "step_s": step_s}


def _quiet(*_args, **_kw) -> None:
    return None


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
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="under torchrun: the ranks each model is sharded over (the rest of "
                         "the world splits the batch)")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    world = None
    if "RANK" in os.environ:
        from repro_torch.parallel import init_tp

        world = init_tp(args.device)
    elif args.mesh_model != 1:
        raise SystemExit("--mesh-model needs several ranks: run under torchrun "
                         "(python -m torch.distributed.run --nproc-per-node N ...)")
    try:
        out = train(get_config(args.arch, smoke=args.smoke), steps=args.steps, batch=args.batch,
                    seq=args.seq, lr=args.lr, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                    log_every=args.log_every, device=args.device, world=world,
                    mesh_model=args.mesh_model)
    finally:
        if world is not None:
            from repro_torch.parallel import shutdown_tp

            shutdown_tp()
    first, last = out["first"], out["last"]
    if world is None or world.rank == 0:
        print(f"loss {first:.4f} -> {last:.4f} ({'improved' if last < first else 'NOT improved'})")
    return first, last


if __name__ == "__main__":
    main()
