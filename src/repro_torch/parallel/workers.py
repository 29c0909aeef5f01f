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


def greedy_decode(model, params, prompt, n: int, S_max: int, gaps: list | None = None) -> list:
    """Target-only greedy decoding: prefill, then ``n - 1`` decode steps;
    the tokens of every batch row.  With ``gaps`` (a list), the top-2 logit
    gap of row 0 at each position is appended to it (where a speculative
    run leaves the greedy decode, how near a tie the decode was there)."""
    tops = []

    def pick(lg):
        if gaps is not None:
            tops.append(lg[0, -1].float().topk(2).values)
        return lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    lg, cache = model.prefill(params, prompt, S_max=S_max)
    out = [pick(lg)]
    for _ in range(n - 1):
        lg, cache = model.decode_step(params, cache, out[-1], S_max)
        out.append(pick(lg))
    if gaps is not None:
        top = torch.stack(tops)
        gaps += (top[:, 0] - top[:, 1]).tolist()
    return torch.cat(out, 1).tolist()


def _greedy_runs(T, tp, prompts, n: int, S_max: int) -> dict:
    """The target's greedy decode of every prompt: tokens, each position's
    top-2 logit gap, and the seconds it took."""
    from repro_torch.obs.clock import monotonic

    t0 = monotonic()
    gaps = [[] for _ in prompts]
    toks = [greedy_decode(T, tp, p, n, S_max, g)[0] for p, g in zip(prompts, gaps)]
    return {"greedy": toks, "greedy_gaps": gaps, "greedy_s": monotonic() - t0}


def forward(group, cases: list) -> list:
    """Per case {"cfg", "tree", "prompt" [B, P], "enc" (a model with cross
    blocks: the stub encoder states), "spec": (tokens, positions, rows,
    mask) or "chain": (tokens [B, n], n_commit), "decode": [tokens [B, 1],
    ...], "S_max", "moe_form"}: the sharded model's prefill, ``spec_forward``
    or ``chain_forward`` (after the prefill) and ``decode_step`` logits
    (after it), with this rank's head counts, its recurrent heads, and the
    shape of every leaf of its cache after the prefill ("group.block.key")
    — the K/V, MLA latent, encoder K/V or recurrent state leaves of the
    family — and of the first ("cache")."""
    out = []
    for case in cases:
        model, params = build(group, case["cfg"], ("numpy", case["tree"]),
                              case.get("moe_form", "tp"))
        S_max = case["S_max"]
        lp, cache = model.prefill(params, case["prompt"], enc=case.get("enc"), S_max=S_max)
        leaves = _leaf_shapes(cache)
        if "chain" in case:
            toks, n_commit = case["chain"]
            what, (ls, cache) = "chain", model.chain_forward(params, cache, toks, n_commit, S_max)
        else:
            what, (ls, cache) = "spec", model.spec_forward(params, cache, *case["spec"])
        dec = []
        for tok in case["decode"]:
            ld, cache = model.decode_step(params, cache, tok, S_max)
            dec.append(_np(ld))
        c = model.run_cfg
        out.append({"prefill": _np(lp), what: _np(ls), "decode": dec,
                    "heads": (c.n_heads, c.n_kv_heads), "ssm_heads": c.ssm_heads,
                    "cache": next(iter(leaves.values())), "leaves": leaves})
        del model, params, cache
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


def all_reduce_rows(group, parts: np.ndarray, dtype: str = "bfloat16",
                    serving: bool = True) -> dict:
    """``TPGroup.all_reduce`` on the ``serving`` group (the backend's
    all-reduce without ``serving``) of this rank's ``parts[rank]`` [n, d]
    in ``dtype``, whole and then row by row (n all-reduces of one row):
    both sums as float32 numpy."""
    group = group.serving() if serving else group
    x = torch.tensor(parts[group.rank], device=group.device).to(getattr(torch, dtype))
    whole = group.all_reduce(x.clone())
    rows = torch.cat([group.all_reduce(x[i:i + 1].clone()) for i in range(len(x))])
    return {"whole": _np(whole), "rows": _np(rows)}


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


def _rows(batch: dict, rank: int, world: int) -> dict:
    """Data rank ``rank``'s rows of a global numpy batch (every entry split
    along its first axis)."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def tp_train(group, job: dict) -> dict:
    """``_tp_train`` with the shapes of its kernel calls (``_with_shapes``)."""
    return _with_shapes(_tp_train, group, job)


def _tp_train(group, job: dict) -> dict:
    """Tensor-parallel training steps: job {"cfg", "weights" (``build``'s:
    ("numpy", tree) or ("seed", seed, 1.0)), "batches": [global numpy batch
    of each step, in ``launch.steps._feed``'s form], "lr" (``make_train_step``
    kwargs), "mesh_model" (the ranks each model is sharded over; default the
    whole group), "compress" (``grad_compress_pod``: the int8 mean over the
    data ranks), "moe_form", "seq_shard" (the residual stream split over the
    model ranks by sequence, ``make_train_step``'s), "remat", "serve_prompt"
    (token ids: first a serving prefill of them, without a gradient, whose
    collectives are returned), "all_grads" (return every gradient, not
    only the whole tensors'), "record_shapes"}.

    The group is carved into model and data groups
    (``parallel.group.make_train_groups``); this rank's model is the
    weights sharded over its model group, and it trains on its data rank's
    rows of each batch.  Before the steps, the first batch's gradient by
    the step's own gradient half (``launch.steps.sharded_grads``) gives the
    gradients of the tensors every rank holds whole and the clip's global
    norm over the group.  Returns the losses, the step times
    (host clock), this rank's parameters after the steps (numpy, by name),
    those whole gradients, the global norm, the collectives and kernel
    launches of the steps, on a card the bytes allocated when the job
    started, at the first step's start and at the steps' peak, and the
    rank's place."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, sharded_grads
    from repro_torch.obs.clock import monotonic
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel.group import COLLECTIVES, make_train_groups, reset_collective_counts

    cfg = job["cfg"]
    cuda = group.device.type == "cuda"
    start = torch.cuda.memory_allocated(group.device) if cuda else 0  # before this job's tensors
    mg, dg = make_train_groups(group, job.get("mesh_model", group.world))
    model, params = build(mg, cfg, job["weights"], job.get("moe_form", "tp"))
    params.requires_grad_(True)
    serve = None
    if job.get("serve_prompt") is not None:  # a serving forward's collectives, for comparison
        reset_collective_counts()
        with torch.no_grad():
            model.prefill(params, job["serve_prompt"])
        serve = dict(COLLECTIVES)
    batches = [_rows(b, dg.rank, dg.world) for b in job["batches"]]
    compress = job.get("compress", False)
    seq = dict(remat=job.get("remat", "none"), seq_shard=job.get("seq_shard", False))
    # the gradient of the first batch, by the step's own gradient half, for the checks
    grads = sharded_grads(model, params, batches[0], dg, compress, **seq)[1]
    weights = model.shard.norm_weights(params)
    gnorm = float(global_norm([g.float() for g in grads], mg, weights))
    names = [n for n, _ in params.named_parameters()]
    whole = {n: _np(g) for n, g, w in zip(names, grads, weights) if w is None}
    every = {n: _np(g) for n, g in zip(names, grads)} if job.get("all_grads") else None
    del grads
    step = make_train_step(cfg, model, data=dg, grad_compress_pod=compress, **seq, **job["lr"])
    opt = adamw_init(params)
    base = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated(group.device)
    reset_collective_counts()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for batch in batches:
        t0 = monotonic()
        params, opt, loss_t = step(params, opt, batch)
        losses.append(float(loss_t))
        step_s.append(monotonic() - t0)
    out = {"rank": group.rank, "model_rank": mg.rank, "data_rank": dg.rank,
           "losses": losses, "step_s": step_s, "gnorm": gnorm, "whole_grads": whole,
           "grads": every, "params": {n: _np(p) for n, p in params.named_parameters()},
           "collectives": dict(COLLECTIVES), "launches": ops.launch_counts(),
           "serve_collectives": serve}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(group.device)
        out["base_bytes"], out["start_bytes"] = base, start
    return out


def seq_prefill(group, job: dict) -> dict:
    """``_seq_prefill`` with the shapes of its kernel calls (``_with_shapes``)."""
    return _with_shapes(_seq_prefill, group, job)


def _seq_prefill(group, job: dict) -> dict:
    """A prefill with the residual stream split over the ranks by sequence
    beside the whole-sequence one: job {"cfg", "weights" (``build``'s),
    "prompt" [B, P] token ids (or "embeds" [B, P, d]), "enc", "S_max",
    "decode" (greedy steps from each cache, default 0), "moe_form",
    "record_shapes"}.
    Returns both prefills' logits and cache leaves ("group.block.key" ->
    numpy), the greedy tokens decoded from each cache, and the collectives
    and kernel launches of the sequence-sharded prefill alone."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts

    model, params = build(group, job["cfg"], job["weights"], job.get("moe_form", "tp"))
    S_max, n = job["S_max"], job.get("decode", 0)
    feed = {"enc": job.get("enc")}
    feed.update({"embeds": job["embeds"]} if "embeds" in job else {"tokens": job["prompt"]})
    out = {"rank": group.rank}
    for key, seq in (("plain", False), ("seq", True)):
        with torch.no_grad():
            reset_collective_counts()
            ops.reset_launch_counts()
            lg, cache = model.prefill(params, S_max=S_max, seq_shard=seq, **feed)
            if seq:
                out["collectives"], out["launches"] = dict(COLLECTIVES), ops.launch_counts()
            leaves = {f"{gi}.{bi}.{k}": _np(x).copy() for gi, unit in enumerate(cache["groups"])
                      for bi, blk in enumerate(unit) for k, x in blk.items()}
            cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [cur]
            for _ in range(n - 1):
                ld, cache = model.decode_step(params, cache, cur, S_max)
                cur = ld[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(cur)
        out[key] = {"logits": _np(lg), "tokens": torch.cat(toks, 1).tolist() if n else [],
                    "cache": leaves}
        del lg, cache
    return out


def train_step_error(group, cfg, mesh_model: int, kw: dict) -> str:
    """What ``make_train_step(cfg, model, **kw)`` raises on this rank's model
    sharded over its model group of ``mesh_model`` ranks (the world carved
    by ``parallel.group.make_train_groups``), or "" when it builds a step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.parallel.group import make_train_groups

    mg, _ = make_train_groups(group, mesh_model)
    try:
        make_train_step(cfg, make_model(cfg, mg.device, mg), **kw)
    except ValueError as e:
        return str(e)
    return ""


def mesh_train(group, job: dict) -> dict:
    """``launch.train.train`` on this world, carved by job["mesh_model"]:
    job {"cfg", "kw" (``train``'s keyword arguments: steps, batch, seq, lr,
    warmup_steps, ckpt_every), "mesh_model", "ckpt" (an empty directory, or
    None), "cut"}.  An uninterrupted run, then, with "ckpt", a run with
    checkpoints stopped before step "cut" as a preemption would, then one
    resumed from them.  Returns this rank's losses of the first run, its
    step times (host clock) and peak memory on a card, the kernel launches
    of the runs, and with "ckpt" the step the last run resumed at, its
    losses and whether its final parameters and optimizer state equal the
    first run's bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import param_leaves

    ops.reset_launch_counts()
    if group.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(group.device)
    kw = dict(job["kw"], world=group, mesh_model=job["mesh_model"], log=lambda *_: None)
    whole = train(job["cfg"], **kw)
    out = {"rank": group.rank, "losses": whole["losses"], "step_s": whole["step_s"],
           "peak_bytes": torch.cuda.max_memory_allocated(group.device)
           if group.device.type == "cuda" else 0}
    if not job.get("ckpt"):
        return dict(out, launches=ops.launch_counts())
    train(job["cfg"], ckpt=job["ckpt"], stop_at=job["cut"], **kw)
    resumed = train(job["cfg"], ckpt=job["ckpt"], **kw)

    def state(out):
        opt = out["opt"]
        return param_leaves(out["params"]) + opt.mu + opt.nu + opt.master

    same = resumed["opt"].step == whole["opt"].step and all(
        torch.equal(a, b) for a, b in zip(state(whole), state(resumed)))
    return dict(out, start=resumed["start"], resumed_losses=resumed["losses"], bit_equal=same,
                launches=ops.launch_counts())


class _SyncCount:
    """Host syncs inside the ``with`` block, as torch's sync debug mode
    reports them (a CUDA device only; none counted with ``on`` False)."""

    def __init__(self, device, on: bool = True):
        self.on, self.n = on and device.type == "cuda", 0

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
    "record_shapes", "sum" ("ring": not ``_serving``'s order)}.

    The draft gets a process group of its own over the same ranks (the
    async round issues each model's collectives on its own stream).
    Returns per run the tokens and ``SpecStats`` of every prompt, the wall
    time, the kernel launches and collectives of the run and, on a CUDA
    device, the host syncs of ``sync_rounds`` lockstep rounds; the target's
    own greedy decode of every prompt, with each position's top-2 logit gap
    and its seconds; the prefill logits of the first prompt and its cache's
    leaf shapes when asked; this rank's head counts, each model's parameter
    bytes (the draft's 0 when the target drafts for itself), the seconds
    the build took and, on CUDA, the bytes allocated after it, its peak
    and the peak of what came after it (``_built``); with "record_shapes" the
    shapes at which this rank called each kernel wrapper (a
    ``kernels.shapes.ShapeLog``'s ``seen``), so that the caller can hold
    the kernels at them.  No run is warmed first:
    on a card these rounds check correctness (ranks sharing it through
    gloo), they are no speed figure."""
    return _with_shapes(_spec_engine, group, job)


def _with_shapes(fn, group, job: dict) -> dict:
    """``fn(group, job)``, with "shapes", the shapes at which this rank
    called each kernel wrapper (a ``kernels.shapes.ShapeLog``'s ``seen``),
    where the job asks for "record_shapes"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.shapes import ShapeLog

    log = ShapeLog(ops) if job.get("record_shapes") else None
    if log is not None:
        log.install()
    try:
        res = fn(group, job)
    finally:
        if log is not None:
            log.uninstall()
    if log is not None:
        res["shapes"] = log.seen
    return res


def _shared_pair(group, job: dict) -> tuple:
    """(T, tparams, D, dparams) of an engine job whose target and draft are
    sharded over this group: the draft on a process group of its own over
    the same ranks (each model's collectives on its own stream), the
    target's weights when it drafts for itself ("dcfg" None)."""
    dev = group.device
    dgroup = group.new_group()
    w = job["weights"]
    if w[0] == "numpy":
        T, tp = build(group, job["tcfg"], ("numpy", w[1]))
        dsrc = ("numpy", w[2])
    else:
        T, tp = build(group, job["tcfg"], ("seed", w[1], w[3]))
        dsrc = ("seed", w[2], w[3])
    if job["dcfg"] is None:
        return T, tp, make_model(job["tcfg"], dev, dgroup), tp
    return (T, tp) + build(dgroup, job["dcfg"], dsrc)


def _leaf_shapes(cache) -> dict:
    """"group.block.key" -> shape of every leaf of a cache: the K/V, MLA
    latent, encoder K/V and recurrent state leaves at this rank's shapes."""
    return {f"{gi}.{bi}.{key}": tuple(x.shape) for gi, unit in enumerate(cache["groups"])
            for bi, blk in enumerate(unit) for key, x in blk.items()}


def _serving(group, job: dict):
    """The group a serving job's models use: ``TPGroup.serving`` (a 16-bit
    all-reduce in rank order), or with job "sum" "ring" the backend's
    all-reduce (a measurement of what the order costs)."""
    return group if job.get("sum") == "ring" else group.serving()


def _spec_engine(group, job: dict) -> dict:
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts

    group = _serving(group, job)
    dev = group.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = monotonic()
    T, tp, D, dp = _shared_pair(group, job)
    S_max = job["S_max"]
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    res = {"rank": group.rank, "heads": {"target": (T.run_cfg.n_heads, T.run_cfg.n_kv_heads),
                                          "draft": (D.run_cfg.n_heads, D.run_cfg.n_kv_heads)},
           "param_bytes": {"target": _nbytes(tp), "draft": 0 if dp is tp else _nbytes(dp)},
           "runs": {}}
    if dev.type == "cuda":
        res.update(_built(dev))
    res["build_s"] = monotonic() - t0
    if job.get("prefill_logits"):
        lg, cache = T.prefill(tp, prompts[0], S_max=S_max)
        res["prefill_logits"], res["leaves"] = _np(lg), _leaf_shapes(cache)
        del lg, cache
    if job.get("greedy_n"):
        res.update(_greedy_runs(T, tp, prompts, job["greedy_n"], S_max))
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
            stats.append(_spec_stats(st))
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
    if dev.type == "cuda":
        res["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def chain_engine(group, job: dict) -> dict:
    """``ChainSpecEngine`` with target and draft sharded over this group:
    job {"tcfg", "dcfg" (None: the target drafts for itself), "weights" (as
    ``spec_engine``'s), "prompts": [[1, P] int32 ...], "runs": [(label,
    ChainConfig kwargs)], "S_max", "greedy_n" (0: none), "prefill_logits",
    "record_shapes"}.  The draft gets a process group of its own over the
    same ranks (parallel mode runs it on a stream of its own).

    Returns this rank's layout (heads, recurrent heads) of both models; per
    run the tokens and ``ChainStats`` of every prompt, the kernel
    launches, the collectives, the wall time and, on a CUDA device, the
    host syncs of the port over the run (one a round and one a request:
    its first token); the target's greedy decode of every prompt; with
    "prefill_logits" the first prompt's prefill logits and the shape of
    every leaf of that cache; on CUDA the rank's peak memory; with
    "record_shapes" the shapes at which it launched each kernel.  On a
    card shared by the ranks through gloo these runs check correctness,
    they are no speed figure."""
    return _with_shapes(_chain_engine, group, job)


def _chain_engine(group, job: dict) -> dict:
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts

    group = _serving(group, job)
    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    T, tp, D, dp = _shared_pair(group, job)
    S_max = job["S_max"]
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    res = {"rank": group.rank, "runs": {},
           "layout": {role: {"heads": (m.run_cfg.n_heads, m.run_cfg.n_kv_heads),
                             "ssm_heads": m.run_cfg.ssm_heads} for role, m in (("target", T),
                                                                               ("draft", D))}}
    if job.get("prefill_logits"):
        lg, cache = T.prefill(tp, prompts[0], S_max=S_max)
        res["prefill_logits"], res["leaves"] = _np(lg), _leaf_shapes(cache)
        del lg, cache
    if job.get("greedy_n"):
        res["greedy"] = [greedy_decode(T, tp, p, job["greedy_n"], S_max)[0] for p in prompts]
    for label, kw in job["runs"]:
        sess = ChainSpecEngine(T, D, ChainConfig(**kw), S_max, S_max).session(tp, dp)
        ops.reset_launch_counts()
        reset_collective_counts()
        outs, stats = [], []
        t0 = monotonic()
        with _SyncCount(dev) as sc:
            for p in prompts:
                out, st = sess.generate(p)
                outs.append(out[0])
                stats.append(_chain_stats(st))
            if cuda:
                torch.cuda.synchronize(dev)
        run = {"tokens": outs, "stats": stats, "wall_s": monotonic() - t0,
               "launches": ops.launch_counts(), "collectives": dict(COLLECTIVES),
               "rounds": sum(st["rounds"] for st in stats)}
        if cuda:
            run["syncs"] = {"syncs": sc.n, "rounds": run["rounds"], "requests": len(prompts)}
        res["runs"][label] = run
    if cuda:
        res["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def model_api(group, job: dict) -> dict:
    """A model of cross blocks through the Model API, sharded over this
    group: job {"cfg", "weights": ("seed", seed, lm_head_scale), "prompt" [1,
    P], "enc_seed" (stub encoder states [1, n_enc, d], drawn on the host
    from it), "steps", "S_max", "record_shapes"}.  Prefill with the encoder
    states, ``steps`` greedy ``decode_step``s, then one ``spec_forward`` of
    the tokens those steps took, from a copy of the prompt's cache, under a
    causal chain mask.  Returns the prefill logits, the decode's tokens, the
    spec_forward's argmax at every position, the kernel launches of the
    three, this rank's heads and cache leaf shapes and, on CUDA, its peak
    memory."""
    return _with_shapes(_model_api, group, job)


def _model_api(group, job: dict) -> dict:
    from repro_torch.kernels import ops

    dev = group.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, S = job["cfg"], job["S_max"]
    model, params = build(group, cfg, job["weights"])
    enc = encoder_states(cfg, job["enc_seed"]).to(dev)
    prompt = np.asarray(job["prompt"], np.int32)
    P, n = prompt.shape[1], job["steps"]
    ops.reset_launch_counts()
    lg, cache = model.prefill(params, prompt, enc=enc, S_max=S)
    res = {"rank": group.rank, "prefill_logits": _np(lg), "leaves": _leaf_shapes(cache),
           "heads": (model.run_cfg.n_heads, model.run_cfg.n_kv_heads)}
    snap = {"len": cache["len"], "groups": [tuple({k: v.clone() for k, v in blk.items()}
                                                  for blk in unit) for unit in cache["groups"]]}
    toks = [lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
    for _ in range(n):
        lg, cache = model.decode_step(params, cache, toks[-1], S)
        toks.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    pos = (P + torch.arange(n, device=dev, dtype=torch.int32))[None]
    mask = torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None]
    sl, _ = model.spec_forward(params, snap, torch.cat(toks[:-1], 1), pos, pos, mask)
    res.update(decode=torch.cat(toks, 1)[0].tolist(), spec_argmax=sl[0].argmax(-1).tolist(),
               launches=ops.launch_counts())
    if dev.type == "cuda":
        res["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def encoder_states(cfg, seed: int) -> torch.Tensor:
    """Seeded stub encoder states [1, n_enc, d] (float32, on the host): the
    same on every rank and in the caller that holds them against the
    single-process model."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((1, cfg.n_enc_tokens, cfg.d_model), generator=gen)


def _built(dev) -> dict:
    """On a card, once a job's models are built: the bytes allocated and
    the build's peak (weights are drawn whole in float32 and sliced, so a
    rank's build briefly holds its largest whole tensor); the peak is reset
    so that the job's own peak is that of its serving runs."""
    torch.cuda.synchronize(dev)
    out = {"allocated_after_build": torch.cuda.memory_allocated(dev),
           "build_peak": torch.cuda.max_memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    return out


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


def _role_params(split, own, w, self_draft: bool):
    """This rank's weights of its role's model ``own``: ``w`` is ("numpy",
    ttree, dtree) — the reference's unboxed trees of the whole models — or
    ("seed", tseed, dseed, lm_head_scale); a self-drafting draft takes the
    target's."""
    from repro_torch.parallel.shard import shard_params

    target = split.role == "target" or self_draft
    if w[0] == "numpy":
        params = params_from_numpy(own.cfg, w[1] if target else w[2], split.device)
        return params if split.model_group is None else \
            shard_params(own.cfg, params, split.model_group)
    params = own.init(w[1] if target else w[2])
    if w[3] != 1.0:
        params.lm_head.mul_(w[3])
    return params


def _nbytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def _spec_stats(st) -> dict:
    return {"rounds": st.rounds, "draft_steps": st.draft_steps,
            "emitted_rows": st.emitted_rows.tolist(), "accepted_rows": st.accepted_rows.tolist(),
            "spec_rounds": st.spec_rounds, "spec_commits": st.spec_commits}


def _chain_stats(st) -> dict:
    return {k: v for k, v in dataclasses.asdict(st).items() if k != "wall_s"}


def split_engine(group, job: dict) -> dict:
    """The disaggregated engine: this world split target-first at
    ``job["n_target"]`` (``parallel.split.make_split``), each rank its own
    role's model and a ``StandIn`` for the other's.  Job {"n_target",
    "tcfg", "dcfg" (None: the target drafts for itself, a copy on the draft's
    ranks), "weights": ("numpy", ttree, dtree) or ("seed", tseed, dseed,
    scale), "prompts": [[1, P] int32 ...], "runs": [(label, kind, kwargs)],
    "S_max", "greedy_n" (0: none), "prefill_logits", "sync_rounds",
    "record_shapes", "sum" (as ``spec_engine``'s)}.  A run's kind is "tree"
    (``SpecConfig`` kwargs,
    every prompt through ``generate``), "chain" (``ChainConfig`` kwargs)
    or "continuous" ({"spec": SpecConfig
    kwargs, "slots", "requests": [(rid, prompt, arrival_s, max_new)],
    "round_dt", "solo"}: ``ContinuousBatchingRuntime`` on a ``VirtualClock``,
    with "solo" each request's solo ``generate()`` after it).

    Returns this rank's world rank and role; its parameter bytes, the
    stand-in's tensors (none), on CUDA its memory before and after the
    build, the build's peak and the peak of what came after (``_built``);
    on the target's ranks the target's greedy decode of every prompt (with
    a target of one rank the single-process model's),
    each position's top-2 logit gap and its seconds, and with
    "prefill_logits" the first prompt's prefill logits;
    per run the tokens and every ``SpecStats``/``ChainStats`` field, the
    kernel launches, the collectives, the rounds, which of the session's
    state this rank holds, the wall time and, on CUDA, the host syncs of
    the port (torch's sync debug mode): over a chain or continuous run, or
    over ``sync_rounds`` tree rounds from a fresh prefill; with
    "record_shapes" the shapes at which this rank launched each kernel.
    On a card shared by the ranks through gloo these runs check
    correctness: no speed figure."""
    return _with_shapes(_split_engine, group, job)


def _split_engine(group, job: dict) -> dict:
    from repro_torch.core.chain_engine import ChainConfig, ChainSpecEngine
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts
    from repro_torch.models.api import StandIn
    from repro_torch.parallel.split import make_split
    from repro_torch.serving import ContinuousBatchingRuntime, Request, VirtualClock

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = monotonic()
    split = make_split(_serving(group, job), job["n_target"])
    self_draft = job["dcfg"] is None
    T, D = split.models(job["tcfg"], job["tcfg"] if self_draft else job["dcfg"])
    own, other = (T, D) if split.role == "target" else (D, T)
    params = _role_params(split, own, job["weights"], self_draft)
    tp, dp = (params, None) if split.role == "target" else (None, params)
    S_max = job["S_max"]
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    res = {"rank": group.rank, "role": split.role, "ranks": split.group.ranks,
           "heads": (own.run_cfg.n_heads, own.run_cfg.n_kv_heads), "param_bytes": _nbytes(params),
           "standin": {"is_standin": isinstance(other, StandIn),
                       "tensors": sum(isinstance(v, torch.Tensor) for v in vars(other).values())},
           "runs": {}}
    if cuda:
        res.update(_built(dev), allocated_before=before)
    res["build_s"] = monotonic() - t0
    if job.get("prefill_logits") and split.role == "target":
        res["prefill_logits"] = _np(T.prefill(tp, prompts[0], S_max=S_max)[0])
    if job.get("greedy_n") and split.role == "target":
        res.update(_greedy_runs(T, tp, prompts, job["greedy_n"], S_max))
    for label, kind, kw in job["runs"]:
        ops.reset_launch_counts()
        reset_collective_counts()
        run = {"kind": kind}
        t0 = monotonic()
        with _SyncCount(dev, on=kind != "tree") as sc:
            if kind == "continuous":
                eng = SpecEngine(T, D, SpecConfig(**kw["spec"]), S_max, S_max, split=split)
                rt = ContinuousBatchingRuntime(eng, tp, dp, n_slots=kw["slots"],
                                               clock=VirtualClock(round_dt=kw["round_dt"]))
                rt.submit_trace(Request(rid=rid, prompt=np.asarray(p, np.int32), arrival_s=a,
                                        max_new=n) for rid, p, a, n in kw["requests"])
                out = rt.run()
                run["tokens"] = {rid: out[rid] for rid in sorted(out)}
                run["stats"] = _spec_stats(rt.stepper.spec_stats)
                run["rounds"] = rt.stepper.spec_stats.rounds
                sess = rt.stepper.session
            else:
                if kind == "chain":
                    eng = ChainSpecEngine(T, D, ChainConfig(**kw), S_max, S_max, split=split)
                else:
                    eng = SpecEngine(T, D, SpecConfig(**kw), S_max, S_max, split=split)
                sess = eng.session(tp, dp)
                run["tokens"], run["stats"] = [], []
                for p in prompts:
                    out, st = sess.generate(p)
                    run["tokens"].append(out[0])
                    run["stats"].append(_chain_stats(st) if kind == "chain"
                                        else _spec_stats(st))
                run["rounds"] = sum(st["rounds"] for st in run["stats"])
            if cuda:
                torch.cuda.synchronize(dev)
        run["wall_s"] = monotonic() - t0
        t0 = monotonic()
        run["launches"] = ops.launch_counts()
        run["collectives"] = dict(COLLECTIVES)
        if cuda and kind != "tree":  # the whole run: a chain request's first token adds one
            run["syncs"] = {"syncs": sc.n, "rounds": run["rounds"],
                            "requests": len(prompts) if kind == "chain" else 0}
        elif cuda and job.get("sync_rounds"):  # the rounds alone, from a fresh prefill
            sess.state = eng._prefill_state(tp, dp, prompts[0])
            torch.cuda.synchronize(dev)
            with _SyncCount(dev) as sc:
                for _ in range(job["sync_rounds"]):
                    sess.step()
            run["syncs"] = {"syncs": sc.n, "rounds": job["sync_rounds"], "requests": 0}
        if kind != "chain":
            st = sess.state
            run["holds"] = {f: getattr(st, f) is not None
                            for f in ("tcache", "dcache", "tr", "plan")}
        if kind == "continuous" and kw.get("solo"):
            sess = eng.session(tp, dp)
            run["solo"] = {rid: sess.generate(np.asarray(p, np.int32).reshape(1, -1),
                                              max_new=n)[0][0]
                           for rid, p, _, n in kw["requests"]}
        run["after_s"] = monotonic() - t0  # the sync count's rounds or the solo runs
        res["runs"][label] = run
    if cuda:
        res["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def fleet(group, job: dict) -> dict:
    """Router replicas on disjoint rank groups: this world carved into
    ``job["replicas"]`` splits of ``job["n_target"]`` + ``job["n_draft"]``
    ranks (``parallel.split.make_fleet``), each rank its own replica's role
    model, serving one trace through ``ShardedServingRuntime(fleet=)`` on a
    ``VirtualClock``.  Job {"n_target", "n_draft", "replicas", "tcfg",
    "dcfg" (None: the target drafts for itself), "weights" (as
    ``split_engine``'s), "S_max", "record_shapes", "runs": [(label,
    {"spec": SpecConfig kwargs, "slots", "requests": [(rid, prompt,
    arrival_s, max_new)], "round_dt", "scheduler": SchedulerConfig kwargs
    or None, "solo", "fail": (replica, fleet round) or None})]}.  With
    "fail" the replica's dispatch raises in that fleet round on each of its
    ranks (the run's "error" holds what each rank raised); with "solo" each
    replica's ranks run the solo ``generate()`` of every request it served.

    Returns this rank's world rank, replica, role and role ranks, its
    parameter bytes and the stand-in's tensors, on CUDA its memory before
    the build and its peak; per run the tokens, ``replica_of``,
    the merged summary and fleet report, every replica's ``SpecStats``
    (the mirrors' included), the fleet rounds, the fleet exchanges, the
    own replica's rounds, the collectives (the split's, on the replica's
    group), the kernel launches, the wall time, the mean own round and
    fleet exchange (tracer spans), and on CUDA the host syncs of the port
    over the run.  On a card shared by the ranks through gloo these runs
    check correctness: no speed figure."""
    return _with_shapes(_fleet, group, job)


def _fleet(group, job: dict) -> dict:
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.kernels import ops
    from repro_torch.models.api import StandIn
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.obs.clock import monotonic
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts
    from repro_torch.parallel.split import make_fleet
    from repro_torch.serving import (Request, SchedulerConfig, ShardedServingRuntime,
                                     VirtualClock, fleet_engines)

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = monotonic()
    fl = make_fleet(group, job["n_target"], job["n_draft"], job["replicas"])
    split = fl.split
    self_draft = job["dcfg"] is None
    T, D = split.models(job["tcfg"], job["tcfg"] if self_draft else job["dcfg"])
    own, other = (T, D) if split.role == "target" else (D, T)
    params = _role_params(split, own, job["weights"], self_draft)
    tp, dp = (params, None) if split.role == "target" else (None, params)
    S_max = job["S_max"]
    res = {"rank": group.rank, "replica": fl.replica, "role": split.role,
           "ranks": split.group.ranks, "replica_ranks": split.world.ranks,
           "param_bytes": _nbytes(params),
           "standin": {"is_standin": isinstance(other, StandIn),
                       "tensors": sum(isinstance(v, torch.Tensor) for v in vars(other).values())},
           "runs": {}}
    if cuda:
        torch.cuda.synchronize(dev)
        res["allocated_before"] = before
    res["build_s"] = monotonic() - t0
    for label, kw in job["runs"]:
        eng = SpecEngine(T, D, SpecConfig(**kw["spec"]), S_max, S_max, split=split)
        tracer = Tracer()
        sched = kw.get("scheduler")
        rt = ShardedServingRuntime(fleet_engines(fl, eng), tp, dp, n_slots=kw["slots"],
                                   clock=VirtualClock(round_dt=kw["round_dt"]), tracer=tracer,
                                   metrics=MetricsRegistry(),
                                   scheduler=None if sched is None else SchedulerConfig(**sched),
                                   fleet=fl)
        rt.submit_trace(Request(rid=rid, prompt=np.asarray(p, np.int32), arrival_s=a,
                                max_new=n) for rid, p, a, n in kw["requests"])
        mine = rt.steppers[fl.replica]
        fail = kw.get("fail")
        if fail is not None and fail[0] == fl.replica:
            step = mine.step

            def failing(step=step, at=fail[1], rt=rt):
                if rt.rounds >= at:
                    raise RuntimeError(f"a failure in replica {fl.replica}'s round {rt.rounds}")
                return step()

            mine.step = failing
        ops.reset_launch_counts()
        reset_collective_counts()
        fl.exchanges = 0
        run = {"error": None}
        t0 = monotonic()
        with _SyncCount(dev) as sc:
            try:
                rt.run()
            except RuntimeError as e:
                if fail is None:
                    raise
                run["error"] = str(e)
            if cuda:
                torch.cuda.synchronize(dev)
        run["wall_s"] = monotonic() - t0
        out = rt.results
        run.update(
            tokens={rid: out[rid] for rid in sorted(out)},
            replica_of={rid: rt.replica_of(rid) for rid, *_ in kw["requests"]},
            summary=rt.summary(), report=rt.report(),
            spec_stats=[_spec_stats(st.spec_stats) for st in rt.steppers],
            fleet_rounds=rt.rounds, exchanges=fl.exchanges, own_rounds=mine.spec_stats.rounds,
            collectives=dict(COLLECTIVES), launches=ops.launch_counts(),
            round_ms=_mean_ms(tracer.spans("round")),
            exchange_ms=_mean_ms(tracer.spans("fleet_exchange")))
        if cuda:
            run["syncs"] = {"syncs": sc.n, "rounds": mine.spec_stats.rounds}
        if kw.get("solo") and run["error"] is None:
            sess = eng.session(tp, dp)
            run["solo"] = {rid: sess.generate(np.asarray(p, np.int32).reshape(1, -1),
                                              max_new=n)[0][0]
                           for rid, p, _, n in kw["requests"]
                           if run["replica_of"][rid] == fl.replica}
        res["runs"][label] = run
    if cuda:
        res["peak_allocated"] = torch.cuda.max_memory_allocated(dev)
    return res


def _mean_ms(spans) -> float:
    return sum(s.dur for s in spans) / len(spans) * 1e3 if spans else 0.0


def resplit(group, job: dict) -> list:
    """``runtime.elastic.reshard_engine`` across splits: job {"splits":
    [n_target, ...], "tcfg", "dcfg", "ttree", "dtree" (the whole models'
    numpy trees), "prompts", "spec" (SpecConfig kwargs), "S_max"}.  The
    engine starts on the first split, cut from the whole weights, and is
    re-split to each next one; per split, this rank's role and the tokens
    of every prompt."""
    from repro_torch.core.engine import SpecConfig, SpecEngine
    from repro_torch.parallel.split import make_split
    from repro_torch.runtime.elastic import reshard_engine

    host = torch.device("cpu")
    whole_t = params_from_numpy(job["tcfg"], job["ttree"], host)
    whole_d = params_from_numpy(job["dcfg"], job["dtree"], host)
    first = make_split(group, job["splits"][0])
    T, D = first.models(job["tcfg"], job["dcfg"])
    eng = SpecEngine(T, D, SpecConfig(**job["spec"]), job["S_max"], job["S_max"], split=first)
    out = []
    for n_target in job["splits"]:
        eng, tp, dp = reshard_engine(eng, whole_t, whole_d, group, n_target)
        sess = eng.session(tp, dp)
        out.append({"role": eng.split.role, "ranks": eng.split.group.ranks,
                    "tokens": [sess.generate(p)[0][0] for p in job["prompts"]]})
    return out


def remat_counts(group, job: dict) -> dict:
    """The dry run's checks on a real group: job {"cfg", "seed", "batch"
    (a train batch, numpy), "prompt" [B, P] ids, "S_max"}.  This rank's
    gradient of ``batch`` with ``remat`` "none" and "full"
    (``launch.steps.loss_and_grads``, before ``Shard.reduce_grads``), and
    the collectives (``COLLECTIVES``) of one train step per remat
    (``make_train_step``), of a prefill of ``prompt`` and of one decode
    step after it, and of the prefill and the train steps again with the
    residual stream sequence-sharded ("prefill_seq", "train_seq_<remat>")."""
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.group import COLLECTIVES, reset_collective_counts

    cfg = job["cfg"]
    model, params = build(group, cfg, ("seed", job["seed"], 1.0))
    counts, grads = {}, {}
    with torch.no_grad():
        reset_collective_counts()
        _, cache = model.prefill(params, job["prompt"], S_max=job["S_max"])
        counts["prefill"] = dict(COLLECTIVES)
        reset_collective_counts()
        model.decode_step(params, cache, np.zeros((len(job["prompt"]), 1), np.int32),
                          job["S_max"])
        counts["decode"] = dict(COLLECTIVES)
        reset_collective_counts()
        model.prefill(params, job["prompt"], S_max=job["S_max"], seq_shard=True)
        counts["prefill_seq"] = dict(COLLECTIVES)
    params.requires_grad_(True)
    for remat in ("none", "full"):
        grads[remat] = [_np(g) for g in loss_and_grads(model, params, job["batch"], remat)[1]]
        for seq in (False, True):
            reset_collective_counts()
            make_train_step(cfg, model, remat=remat, seq_shard=seq)(params, adamw_init(params),
                                                                    job["batch"])
            counts[f"train_seq_{remat}" if seq else f"train_{remat}"] = dict(COLLECTIVES)
    return {"rank": group.rank, "grads": grads, "collectives": counts}


def several(group, calls: list) -> list:
    """Every (name, args) of ``calls``: the rank program ``name`` of this
    module on ``args``, in order on one group (one spawn for several
    checks).  What a call built is freed before the next starts (on a
    card, handed back to the device: the ranks share it)."""
    import gc

    out = []
    for name, args in calls:
        out.append(globals()[name](group, *args))
        gc.collect()
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def foreign_modules(group) -> list:
    """The JAX and JAX-package modules this rank has loaded: none, since a
    rank imports the port only."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
