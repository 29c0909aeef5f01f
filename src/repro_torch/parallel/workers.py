"""Rank programs: what every rank of a tensor-parallel run does.

Each is ``fn(group, *args)`` for ``parallel.spawn.run_ranks``: it builds
this rank's models from the arguments (numpy weights of the whole,
unpadded model, or a seed to draw them), runs the sharded forward, the MoE,
the collectives or the speculative engine, and returns plain Python and
numpy values (the whole logits and tokens on every rank), which the caller
holds against a single-process run and compares across ranks.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.models.api import make_model
from repro_torch.parallel.shard import shard_params


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


def build(group, cfg, weights, moe_form: str = "tp"):
    """(model, params) of this rank: ``weights`` is ("numpy", tree) — the
    reference's unboxed tree of the whole model, converted then sharded —
    or ("seed", seed, lm_head_scale) — drawn tensor by tensor, each padded
    and sliced as it is drawn (``Model.init``)."""
    model = make_model(cfg, group.device, group, moe_form)
    if weights[0] == "numpy":
        params = shard_params(cfg, params_from_numpy(cfg, weights[1], group.device), group,
                              moe_form)
    else:
        _, seed, scale = weights
        params = model.init(seed)
        if scale != 1.0:
            params.lm_head.mul_(scale)
    return model, params


def greedy_decode(model, params, prompt, n: int, S_max: int) -> list:
    """Target-only greedy decoding: prefill, then ``n - 1`` decode steps;
    the tokens of every batch row."""
    lg, cache = model.prefill(params, prompt, S_max=S_max)
    cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    out = [cur]
    for _ in range(n - 1):
        lg, cache = model.decode_step(params, cache, cur, S_max)
        cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(cur)
    return torch.cat(out, 1).tolist()


def forward(group, cases: list) -> list:
    """Per case {"cfg", "tree", "prompt" [B, P], "spec": (tokens, positions,
    rows, mask), "decode": [tokens [B, 1], ...], "S_max", "moe_form"}: the
    sharded model's prefill, ``spec_forward`` (after the prefill) and
    ``decode_step`` logits (after the spec forward), with this rank's head
    counts and cache leaf shape."""
    out = []
    for case in cases:
        model, params = build(group, case["cfg"], ("numpy", case["tree"]),
                              case.get("moe_form", "tp"))
        S_max = case["S_max"]
        lp, cache = model.prefill(params, case["prompt"], S_max=S_max)
        ls, cache = model.spec_forward(params, cache, *case["spec"])
        dec = []
        for tok in case["decode"]:
            ld, cache = model.decode_step(params, cache, tok, S_max)
            dec.append(_np(ld))
        leaf = cache["groups"][0][0]["k"]
        out.append({"prefill": _np(lp), "spec": _np(ls), "decode": dec,
                    "heads": (model.run_cfg.n_heads, model.run_cfg.n_kv_heads),
                    "cache": tuple(leaf.shape)})
    return out


def moe(group, cases: list) -> list:
    """Per case {"cfg", "routed", "shared", "x" [B, n, d], "moe_form"}: the
    sharded ``moe_apply`` of the whole experts' weights, and whether this
    rank ran the expert-parallel form."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.shard import Shard

    out = []
    for case in cases:
        sh = Shard(case["cfg"], group.rank, group.world, case["moe_form"])

        def part(where, tensors):
            return None if tensors is None else {
                k: sh.tensor(where, k, torch.tensor(v, device=group.device))
                for k, v in tensors.items()}

        y = moe_apply(sh.local_cfg, part("moe", case["routed"]), part("shared", case["shared"]),
                      torch.tensor(case["x"], device=group.device), tp=group, ep=sh.ep)
        out.append({"out": _np(y), "ep": sh.ep})
    return out


def collectives(group, x: np.ndarray, w: np.ndarray) -> dict:
    """``matmul_allreduce`` on this rank's rows of w and
    ``matmul_ag_pipelined`` on its columns of x (x [M, K], w [K, N])."""
    from repro_torch.core.collective_matmul import matmul_ag_pipelined, matmul_allreduce

    p, r = group.world, group.rank
    xt, wt = torch.tensor(x, device=group.device), torch.tensor(w, device=group.device)
    k = x.shape[1] // p
    return {"allreduce": _np(matmul_allreduce(xt, wt[r * k:(r + 1) * k], group)),
            "ag_pipelined": _np(matmul_ag_pipelined(xt[:, r * k:(r + 1) * k], wt, group))}


def compressed_mean(group, grads: list) -> np.ndarray:
    """``pod_allreduce_compressed`` of ``grads[rank]``."""
    from repro_torch.optim.compression import pod_allreduce_compressed

    return _np(pod_allreduce_compressed(torch.tensor(grads[group.rank], device=group.device),
                                        group))


def batches(group, data_cfg, start_step: int, n: int) -> list:
    """This rank's rows of ``n`` batches from ``start_step`` on."""
    from repro_torch.data import SyntheticLMDataset, sharded_batches

    it = sharded_batches(SyntheticLMDataset(data_cfg), group, start_step)
    return [(b["step"], _np(b["tokens"])) for b, _ in zip(it, range(n))]


def train(group, cfg, tree, data_cfg, steps: int, lr: dict) -> dict:
    """``steps`` data-parallel train steps with ``grad_compress_pod``: every
    rank a replica of the whole model on its rows of each batch.  Returns
    the losses and the final parameters."""
    from repro_torch.data import SyntheticLMDataset, sharded_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    model = make_model(cfg, group.device)
    params = params_from_numpy(cfg, tree, group.device).requires_grad_(True)
    opt = adamw_init(params)
    step = make_train_step(cfg, model, grad_compress_pod=True, **lr)
    losses = []
    for batch, _ in zip(sharded_batches(SyntheticLMDataset(data_cfg), group), range(steps)):
        params, opt, loss = step(params, opt, {"tokens": batch["tokens"]})
        losses.append(float(loss))
    return {"losses": losses, "params": {k: _np(v) for k, v in params.named_parameters()}}


class _SyncCount:
    """Host syncs inside the ``with`` block, as torch's sync debug mode
    reports them (a CUDA device only)."""

    def __init__(self, device):
        self.on, self.n = device.type == "cuda", 0

    def __enter__(self):
        if self.on:
            self._w = warnings.catch_warnings(record=True)
            self._log = self._w.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode("default")
            self._w.__exit__(*exc)
            self.n = sum(1 for w in self._log if "synchroniz" in str(w.message)
                         and "prototype" not in str(w.message))
        return False


def spec_engine(group, job: dict) -> dict:
    """The speculative engine with target and draft sharded over this
    group: job {"tcfg", "dcfg" (None: the target drafts for itself),
    "weights": ("numpy", ttree, dtree) or ("seed", tseed, dseed, scale),
    "prompts": [[1, P] int32 ...], "runs": [(label, SpecConfig kwargs)],
    "S_max", "greedy_n" (0: none), "prefill_logits", "sync_rounds",
    "record_shapes"}.

    The draft gets a process group of its own over the same ranks (the
    async round issues each model's collectives on its own stream).
    Returns per run the tokens and ``SpecStats`` of every prompt, the wall
    time, the kernel launches and collectives of the run and, on a CUDA
    device, the host syncs of ``sync_rounds`` lockstep rounds; the target's
    own greedy decode of every prompt; the prefill logits of the first
    prompt when asked; this rank's head counts; with "record_shapes" the
    shapes at which this rank called each kernel wrapper (a
    ``kernels.shapes.ShapeLog``'s ``seen``), so that the caller can hold
    the kernels at them.  No run is warmed first:
    on a card these rounds check correctness (ranks sharing it through
    gloo), they are no speed figure."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.shapes import ShapeLog

    log = ShapeLog(ops) if job.get("record_shapes") else None
    if log is not None:
        log.install()
    try:
        res = _spec_engine(group, job)
    finally:
        if log is not None:
            log.uninstall()
    if log is not None:
        res["shapes"] = log.seen
    return res


def _spec_engine(group, job: dict) -> dict:
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts

    dev = group.device
    dgroup = group.new_group()
    w = job["weights"]
    self_draft = job["dcfg"] is None
    if w[0] == "numpy":
        T, tp = build(group, job["tcfg"], ("numpy", w[1]))
        dsrc = ("numpy", w[2])
    else:
        T, tp = build(group, job["tcfg"], ("seed", w[1], w[3]))
        dsrc = ("seed", w[2], w[3])
    if self_draft:
        D, dp = make_model(job["tcfg"], dev, dgroup), tp
    else:
        D, dp = build(dgroup, job["dcfg"], dsrc)
    S_max = job["S_max"]
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    res = {"rank": group.rank, "heads": {"target": (T.run_cfg.n_heads, T.run_cfg.n_kv_heads),
                                          "draft": (D.run_cfg.n_heads, D.run_cfg.n_kv_heads)},
           "runs": {}}
    if job.get("prefill_logits"):
        res["prefill_logits"] = _np(T.prefill(tp, prompts[0], S_max=S_max)[0])
    if job.get("greedy_n"):
        res["greedy"] = [greedy_decode(T, tp, p, job["greedy_n"], S_max)[0] for p in prompts]
    for label, kw in job["runs"]:
        eng = SpecEngine(T, D, SpecConfig(**kw), S_max_t=S_max, S_max_d=S_max)
        sess = eng.session(tp, dp)
        ops.reset_launch_counts()
        reset_collective_counts()
        outs, stats = [], []
        t0 = monotonic()
        for p in prompts:
            out, st = sess.generate(p)
            outs.append(out[0])
            stats.append({"rounds": st.rounds, "draft_steps": st.draft_steps,
                          "emitted_rows": st.emitted_rows.tolist(),
                          "accepted_rows": st.accepted_rows.tolist(),
                          "spec_rounds": st.spec_rounds, "spec_commits": st.spec_commits})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run = {"tokens": outs, "stats": stats, "wall_s": monotonic() - t0,
               "launches": ops.launch_counts(), "collectives": dict(COLLECTIVES)}
        if dev.type == "cuda" and job.get("sync_rounds"):
            sess.state = eng._prefill_state(tp, dp, prompts[0])
            torch.cuda.synchronize(dev)
            with _SyncCount(dev) as sc:
                for _ in range(job["sync_rounds"]):
                    sess.step()
            run["syncs_per_round"] = sc.n / job["sync_rounds"]
        if dev.type == "cuda" and job.get("trace_rounds"):
            run["trace"] = _trace_rounds(eng, sess, tp, dp, prompts[0], job["trace_rounds"],
                                         f"{job['trace_path']}.{label}.rank{group.rank}.json")
        res["runs"][label] = run
    return res


def _trace_rounds(eng, sess, tp, dp, prompt, rounds: int, path: str) -> dict:
    """A torch.profiler trace of ``rounds`` rounds on this rank (after one
    warm round), written to ``path`` (its kernels only): the wall time, the
    kernels and their summed device time.  Every rank runs the rounds."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.clock import monotonic

    sess.state = eng._prefill_state(tp, dp, prompt)
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
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    with open(path, "w") as f:
        json.dump({"traceEvents": kernels}, f)
    return {"rounds": rounds, "wall_ms": wall_ms, "kernels": len(kernels),
            "busy_ms": sum(e["dur"] for e in kernels) / 1e3}


def several(group, calls: list) -> list:
    """Every (name, args) of ``calls``: the rank program ``name`` of this
    module on ``args``, in order on one group (one spawn for several
    checks)."""
    return [globals()[name](group, *args) for name, args in calls]


def foreign_modules(group) -> list:
    """The JAX and JAX-package modules this rank has loaded: none, since a
    rank imports the port only."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
