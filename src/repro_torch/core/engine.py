"""SpecEngine — tree-based speculative decoding (``repro.core.engine``;
paper §3.1, Algorithm 1, Figure 3).

Lockstep round (``EngineSession.step``): verify the draft tree on the target
and walk it greedily, compact the target cache, run ``d`` draft expansions,
make the round's one host sync, re-root the tree and move the draft-cache
rows, fill the prefix KV, grow the tree, select the next verify batch.
``mode="serial"`` is the SwiftSpec-base baseline (the d expansions run after
verification instead of beside it).

Async round (``async_rounds``): ``dispatch_verify`` enqueues the verify,
``draft_next_tree`` finishes the round's expansions, predicts the accept
path and drafts round N+1's tree on it, and ``reconcile`` makes the round's
one host sync, then adopts the lookahead or rolls back to the retained
snapshot.  On the card the target runs on one CUDA stream and the draft on
another, both on one device, so the draft's kernels run beside the
verify's; on the CPU the same code runs with no streams.  A lockstep engine
runs everything on the caller's current stream.

Continuous batching: ``admit_slot`` prefills one request solo and installs
its caches into one batch row (``core/kv.py``'s ``install_slot``, one
``slot_write_rows`` launch per cache), ``release_slot`` zeroes the row.

Every cache a round owns is written in place (``core/kv.py``), except the
async lookahead's, which re-roots into a fresh cache so that the snapshot
survives until ``reconcile``.

Tensor parallelism: target and draft may both be sharded over the same
ranks (``models.api.make_model(..., group=)``).  Every rank then runs this
host loop on the same logits, so every host decision is the same on every
rank; the async round gives each model a process group of its own, whose
collectives run on that model's stream.

Disaggregated (``split=``, ``parallel/split.py``): target and draft on
disjoint rank groups, one process per rank.  A rank runs its own role's
part of every method — the target's ranks verify and compact, the draft's
expand, re-root, fill and grow — and holds nothing of the other role: its
model is a ``StandIn``, and its ``EngineState`` has None for the other
role's caches, tree and plan.  The roles meet in one order of world
collectives a round: the plan (draft -> target) at the start, the verdict
(target -> every rank) and, in the async round, the prediction (draft ->
every rank) at its end.  The draft sends its plan before its expansions
and enqueues its lookahead before it waits for the verdict, so its work
runs beside the verify.  Every rank then makes the round's one host sync,
one transfer of the verdict (and the prediction), and takes the same
host decisions from it: the emitted tokens, the async ``ok``, every
``SpecStats`` field.  A split rank runs one role, so it needs no second
stream.

Greedy-verification invariant: the emitted stream equals target-only greedy
decoding token for token.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import indexed_device
from repro_torch.core import kv as kvm
from repro_torch.core import tree as T
from repro_torch.core.scheduler import ProfileResult
from repro_torch.models.api import StandIn
from repro_torch.obs.clock import monotonic
from repro_torch.obs.trace import NOOP_SPAN, NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    bs: int = 8  # target verification batch (paper §5.5: 8)
    w: int = 4  # draft leaves expanded per step (paper §5.5: 8)
    c: int = 2  # children proposed per expanded leaf
    d: int = 3  # tree expansions per round (profiled: ~t_target/t_draft)
    n_cap: int = 64  # tree node capacity
    mode: str = "parallel"  # "parallel" | "serial"
    max_new: int = 64
    eos_id: int = -1  # -1: never stop early
    draft_bypass: bool = False  # straggler mitigation: verify root-only chain
    async_rounds: bool = False  # pipeline rounds: draft N+1's tree while N verifies


@dataclasses.dataclass
class SpecStats:
    """Per-row exact accounting: ``emitted_rows``/``accepted_rows`` hold one
    running total per batch row; the scalar views are per-row means."""

    rounds: int = 0
    draft_steps: int = 0
    wall_s: float = 0.0
    emitted_rows: np.ndarray | None = None  # i64[B] per-row emitted totals
    accepted_rows: np.ndarray | None = None  # i64[B] per-row accepted totals
    spec_rounds: int = 0  # rounds run through the async lookahead path
    spec_commits: int = 0  # of those, rounds whose lookahead tree was adopted

    def add_round(self, n_emitted, n_accepted):
        n_emitted = np.asarray(n_emitted, np.int64)
        if self.emitted_rows is None:
            self.emitted_rows = np.zeros_like(n_emitted)
            self.accepted_rows = np.zeros_like(n_emitted)
        self.emitted_rows += n_emitted
        self.accepted_rows += np.asarray(n_accepted, np.int64)
        self.rounds += 1

    @property
    def emitted(self) -> float:
        return 0.0 if self.emitted_rows is None else float(self.emitted_rows.mean())

    @property
    def accepted(self) -> float:
        return 0.0 if self.accepted_rows is None else float(self.accepted_rows.mean())

    @property
    def total_emitted(self) -> int:
        return 0 if self.emitted_rows is None else int(self.emitted_rows.sum())

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / max(self.rounds, 1)

    @property
    def compression_ratio(self) -> float:
        """Paper's metric: tokens per target-model inference."""
        return self.tokens_per_round


@dataclasses.dataclass
class EngineState:
    """Device-side state of one decode batch.  Treat it linearly: a round
    writes the caches in place and replaces the tree and plan, and an
    in-flight async round owns it until ``reconcile``."""

    tcache: Any  # target KV cache [U, B, S_max_t, ...]
    dcache: Any  # draft KV cache [U, B, S_max_d, ...]
    tr: Any  # batched Tree, leaves [B, ...]
    plan: Any  # BatchPlan for the NEXT verification, leaves [B, ...]


@dataclasses.dataclass(frozen=True)
class StepResult:
    """Host-side outcome of one round, per batch row."""

    emitted: np.ndarray  # i32[B, bs+1] verified tokens (accepted + bonus)
    n_emitted: np.ndarray  # i32[B]
    n_accepted: np.ndarray  # i32[B]


@dataclasses.dataclass
class RoundInFlight:
    """One dispatched, not yet reconciled async round: made by
    ``dispatch_verify`` + ``draft_next_tree``, consumed once by
    ``reconcile``.  Every tensor here is device work still in flight;
    nothing has reached the host."""

    plan: Any  # BatchPlan submitted to verify (post-bypass)
    tcache: Any  # verify-compacted target cache (right whatever the outcome)
    verify: tuple  # (acc_pos, n_acc, bonus, emitted, n_emitted)
    snapshot: tuple | None = None  # (tr, dcache) post-expansion, pre-reroot
    lookahead: tuple | None = None  # (tr, dcache, plan) drafted for round N+1
    pred: tuple | None = None  # (acc_pos, n_acc, bonus) predicted outcome
    pred_ready: Any = None  # CUDA event on the draft stream after ``pred``
    draft_steps: int = 0
    verify_span: Any = NOOP_SPAN  # open until the reconcile sync (verify window)


def _effective_depth(depth: int | None, default: int) -> int:
    """A round's draft depth: a host-side loop count, None = the config's d."""
    if depth is None:
        return default
    d = int(depth)
    if d < 1:
        raise ValueError(f"draft depth must be >= 1, got {depth}")
    return d


def absorb_emitted(out: list, emitted_row, n_emitted: int, max_new: int, eos_id: int):
    """Append one row's verified tokens to ``out`` until EOS or ``max_new``
    (token appended first, then tested).  Returns (new_tokens, done)."""
    new = []
    for t in emitted_row[:n_emitted].tolist():
        out.append(int(t))
        new.append(int(t))
        if (eos_id >= 0 and t == eos_id) or len(out) >= max_new:
            return new, True
    return new, False


def engine_device(target, draft, target_devices=None, draft_devices=None,
                  split=None) -> torch.device:
    """The one device an engine runs on (this rank's, under tensor
    parallelism or a split).  ``target_devices`` and ``draft_devices`` are
    the device groups the reference takes as ``mesh_target``/``mesh_draft``
    (``launch/mesh.make_serving_devices``), by default each model's own
    device.  A shared pair runs: both groups the same single device, where
    both models live, or both models sharded over the same ranks (the
    reference's ``SpecEngine(mesh_target=M, mesh_draft=M)``; every rank runs
    this engine on the same logits).  A pair on disjoint devices or groups
    runs only as a ``split`` (``parallel.split``): one process per rank, this
    rank's role's model and a ``StandIn`` for the other's."""
    if split is not None:
        return _split_device(target, draft, split, target_devices, draft_devices)
    tdev, ddev = indexed_device(target.device), indexed_device(draft.device)
    tg = (tdev,) if target_devices is None else tuple(map(indexed_device, target_devices))
    dg = (ddev,) if draft_devices is None else tuple(map(indexed_device, draft_devices))
    t_ranks = None if target.group is None else target.group.ranks
    d_ranks = None if draft.group is None else draft.group.ranks
    if tg != dg or len(tg) != 1 or tdev != ddev or t_ranks != d_ranks:
        raise ValueError(
            f"target on {list(tg)} (model on {target.device}, ranks {t_ranks}) and draft on "
            f"{list(dg)} (model on {draft.device}, ranks {d_ranks}) are not one shared device "
            "or group: a split pair runs with one process per rank — launch its ranks "
            "(torchrun, or parallel.spawn.run_ranks) and pass "
            "split=parallel.split.init_split(n_target, n_draft)")
    if tdev != tg[0]:
        raise ValueError(f"the models live on {target.device}, not on the engine's {tg[0]}")
    return target.device


def _split_device(target, draft, split, target_devices, draft_devices) -> torch.device:
    """``engine_device`` on a split: this rank's role's model on the split's
    device and group, the other role a ``StandIn``."""
    if target_devices is not None or draft_devices is not None:
        raise ValueError("a split engine's groups are its split's ranks: pass no "
                         "target_devices / draft_devices")
    own, other = (target, draft) if split.role == "target" else (draft, target)
    other_role = "draft" if split.role == "target" else "target"
    if isinstance(own, StandIn) or not isinstance(other, StandIn):
        raise ValueError(f"on a {split.role} rank of a split the {split.role} is a model and the "
                         f"{other_role} a models.api.StandIn (Split.models): a rank holds its "
                         "own role's weights only")
    if indexed_device(own.device) != indexed_device(split.device):
        raise ValueError(f"the {split.role} model lives on {own.device}, not on this rank's "
                         f"{split.device}")
    ranks = None if own.group is None else own.group.ranks
    want = None if split.model_group is None else split.group.ranks
    if ranks != want:
        raise ValueError(f"the {split.role} model's group (ranks {ranks}) is not its role's "
                         f"({want}): make it with Split.models")
    return split.device


def check_frozen(*params) -> None:
    """Serving runs on frozen weights only: a parameter that requires a
    gradient would make every round build an autograd graph.  Raises for
    one (a trainer's weights; ``Model.init(seed, trainable=True)``)."""
    for p in params:
        if isinstance(p, torch.nn.Module) and any(t.requires_grad for t in p.parameters()):
            raise ValueError("serving takes frozen weights: these parameters require a "
                             "gradient (detach a copy with requires_grad_(False) to serve it)")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(a, device):
    """A host int32 array on ``device`` with no host sync: on the card it is
    copied from pinned memory without blocking."""
    t = torch.tensor(np.asarray(a, np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class StreamPair:
    """What the tree and the chain engine share: the target's and the
    draft's CUDA streams of an engine on the card (``self.streams``, None
    when the engine runs on the caller's stream), and on a split this
    rank's role (``self.split``).

    With streams, all of the engine's device work runs on them: target work
    on the first, draft work on the second.  Tensors cross between them only
    at points the engine orders by a wait or an event (and marks with
    ``record_stream`` for the caching allocator)."""

    streams: tuple | None = None
    device: torch.device
    split: Any = None

    @property
    def multi_process(self) -> bool:
        """Whether several processes run this engine (a split, or models
        sharded over several ranks): they must take the same host decisions
        at the same round."""
        group = getattr(self.target, "group", None)
        return self.split is not None or (group is not None and group.world > 1)

    @property
    def runs_target(self) -> bool:
        """Whether this process runs the target's part (not a draft rank)."""
        return self.split is None or self.split.role == "target"

    @property
    def runs_draft(self) -> bool:
        """Whether this process runs the draft's part (not a target rank)."""
        return self.split is None or self.split.role == "draft"

    def _share(self, buf, src: str, shape):
        """Role ``src``'s int32 ``buf`` on every rank: a broadcast on a
        split (``Split.share``), ``buf`` itself without one."""
        return buf if self.split is None else self.split.share(buf, src, shape)

    def _target(self):
        return torch.cuda.stream(self.streams[0]) if self.streams else contextlib.nullcontext()

    def _draft(self):
        return torch.cuda.stream(self.streams[1]) if self.streams else contextlib.nullcontext()

    def _fork(self) -> None:
        """Order both streams after the caller's work so far (weights drawn,
        anything the caller enqueued)."""
        if self.streams:
            cur = torch.cuda.current_stream(self.device)
            for st in self.streams:
                st.wait_stream(cur)

    def _join(self) -> None:
        """Order the caller's stream after both engine streams."""
        if self.streams:
            cur = torch.cuda.current_stream(self.device)
            for st in self.streams:
                cur.wait_stream(st)


def verdict_widths(bs: int) -> tuple:
    """Columns of a packed verdict: acc_pos, n_acc, bonus, emitted, n_emitted."""
    return (bs, 1, 1, bs + 1, 1)


def pred_widths(bs: int) -> tuple:
    """Columns of a packed prediction: pred_acc, pred_n, pred_bonus."""
    return (bs, 1, 1)


def pack(parts) -> torch.Tensor:
    """int32 [B, ...] of the verdict's or the prediction's tensors ([B] ones
    as a column), in order."""
    return torch.cat([p[:, None] if p.dim() == 1 else p for p in parts], dim=1).to(torch.int32)


def unpack(x, widths) -> list:
    """``pack``'s inverse on host or device: ``x`` [B, sum(widths)] cut into
    its column blocks in order, [B] for a width-1 column."""
    edges = np.cumsum([0, *widths])
    return [x[:, a] if b == a + 1 else x[:, a:b] for a, b in zip(edges[:-1], edges[1:])]


class SpecEngine(StreamPair):
    """Tree-based speculative decoding for dense attention models.  In the
    async round the three crossings are the plan (draft -> target, at
    dispatch), the prediction (draft -> target, at the reconcile transfer)
    and the verify outcome (target -> draft, on rollback).  On a ``split``
    they are world collectives (``parallel/split.py``): the plan, the
    verdict and the prediction, one packed buffer each."""

    def __init__(self, target, draft, cfg: SpecConfig, S_max_t: int, S_max_d: int,
                 target_devices=None, draft_devices=None, split=None):
        self.device = engine_device(target, draft, target_devices, draft_devices, split)
        if cfg.async_rounds and cfg.mode != "parallel":
            raise ValueError(
                f"async_rounds requires mode='parallel' (got mode={cfg.mode!r}): "
                "the lookahead pipeline IS the parallel overlap")
        self.target, self.draft, self.cfg = target, draft, cfg
        self.S_max_t, self.S_max_d = S_max_t, S_max_d
        self.split = split
        # async rounds on the card: the target's stream and the draft's (a
        # split rank runs one role: its rounds overlap across processes)
        self.streams = None
        if cfg.async_rounds and self.device.type == "cuda" and split is None:
            self.streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
            if target.group is not None and target.group.world > 1 and \
                    target.group.pg is draft.group.pg:
                raise ValueError(
                    "async rounds on the card issue the target's and the draft's collectives "
                    "from two streams: give each model a process group of its own over the "
                    "same ranks (TPGroup.new_group)")

    # ----- draft-side steps ---------------------------------------------------
    def _expand(self, dparams, tr, dcache):
        c = self.cfg
        leaf_ids, leaf_valid = T.select_leaves(tr, c.w)
        tokens, rows, positions, mask, _ = T.leaf_inputs(
            tr, leaf_ids, leaf_valid, self.S_max_d, self.draft.cfg.sliding_window)
        logits, dcache = self.draft.spec_forward(dparams, dcache, tokens, positions, rows, mask)
        lp = torch.log_softmax(logits.float(), dim=-1)
        top_lp, top_tok = T.top_k(lp, c.c)  # [B, w, c]
        return T.insert_children(tr, leaf_ids, leaf_valid, rows, top_tok, top_lp), dcache

    def _select_plan(self, tr):
        return T.select_batch(tr, self.cfg.bs, self.S_max_t, self.target.cfg.sliding_window)

    def _kv_move(self, dcache, src, dst, mask):
        dcache = kvm.apply_moves(dcache, src, dst, mask, donate=True)
        return kvm.set_length(dcache, 0)  # length bookkeeping via tree.plen

    def _spec_kv_move(self, dcache, src, dst, mask):
        """The lookahead's move: a fresh cache, ``dcache`` (the rollback
        snapshot) left as it was."""
        dcache = kvm.apply_moves(dcache, src, dst, mask, donate=False)
        return kvm.set_length(dcache, 0)

    def _predict(self, tr, node_ids, parent_pos, valid):
        return T.predict_accept(tr, node_ids, parent_pos, valid)

    def _fill(self, dparams, dcache, fill):
        """Forward the accepted-but-unexpanded tokens into their prefix rows
        (runs every round, as the reference's jitted program does)."""
        cols = torch.arange(self.S_max_d, dtype=torch.int32, device=self.device)
        fmask = (cols[None, None, :] <= fill.rows[:, :, None]) & fill.mask[:, :, None]
        _, dcache = self.draft.spec_forward(dparams, dcache, fill.tokens, fill.positions,
                                            fill.rows, fmask)
        return dcache

    # ----- target-side steps --------------------------------------------------
    def _verify(self, tparams, tcache, plan):
        logits, tcache = self.target.spec_forward(tparams, tcache, plan.tokens, plan.positions,
                                                  plan.rows, plan.mask)
        argmax = logits.argmax(-1).to(torch.int32)
        acc_pos, n_acc, bonus, emitted, n_emitted = T.verify_walk(
            plan.tokens, plan.parent_pos, plan.valid, argmax)
        # compaction plan: accepted rows -> prefix (target Fig. 5 analogue)
        bs = plan.tokens.shape[1]
        slot = torch.arange(bs, dtype=torch.int32, device=self.device)[None, :]
        plen = plan.rows[:, 0] + 1  # root row = plen-1
        src = torch.where(acc_pos >= 0, plan.rows.gather(1, acc_pos.clamp(min=0).long()), -1)
        dst = plen[:, None] + slot
        mmask = (slot < n_acc[:, None]) & (src >= 0)
        return acc_pos, n_acc, bonus, emitted, n_emitted, tcache, (src, dst, mmask)

    def _compact(self, tcache, src, dst, mask):
        return kvm.apply_moves(tcache, src, dst, mask, donate=True)

    # ----- the crossings between the roles ------------------------------------
    def _plan_to_target(self, plan, B: int):
        """The verify batch on the target's ranks: the plan itself, or on a
        split the draft's, broadcast (``Split.plan``)."""
        if self.split is None:
            return plan
        return self.split.plan(plan, B, self.cfg.bs, self.S_max_t)

    def _verdict(self, verify, B: int):
        """(packed verdict [B, 2 bs + 4] on every rank of a split, broadcast
        from the target, else None; its device tensors (acc_pos, n_acc,
        bonus, emitted, n_emitted))."""
        if self.split is None:
            return None, tuple(verify)
        widths = verdict_widths(self.cfg.bs)
        buf = self.split.share(None if verify is None else pack(verify), "target",
                               (B, sum(widths)))
        return buf, (tuple(verify) if verify is not None else
                     tuple(x.contiguous() for x in unpack(buf, widths)))

    def _prediction(self, pred, B: int):
        """The draft's packed prediction [B, bs + 2] on every rank of a
        split, else None."""
        if self.split is None:
            return None
        return self.split.share(None if pred is None else pack(pred), "draft",
                                (B, sum(pred_widths(self.cfg.bs))))

    # ------------------------------------------------------------------
    @property
    def grow_per_round(self) -> int:
        """Expansions needed to refill a re-rooted tree to >= bs nodes."""
        c = self.cfg
        return max(1, -(-(c.bs) // (c.w * c.c)))

    @property
    def plen_budget(self) -> int:
        """Largest per-row prefix length the caches can carry into one more
        round: verify rows reach plen-1+bs and the re-rooted tree needs
        another bs of headroom, so stop ``2*bs`` short of the tighter cache."""
        return min(self.S_max_t, self.S_max_d) - 2 * self.cfg.bs

    def _prefill_state(self, tparams, dparams, prompt) -> EngineState:
        """Whole-batch prefill + tree seed + initial growth (each role its
        part on a split)."""
        c = self.cfg
        B, P = prompt.shape
        self._fork()
        tcache = dcache = tr = plan = None
        if self.runs_draft:
            with self._draft():
                tokens = _to_device(prompt, self.device)
                dlogits, dcache = self.draft.prefill(dparams, tokens, S_max=self.S_max_d)
                tr = T.init_tree(c.n_cap, B, self.device)
                tr = T.seed_root(tr, tokens[:, -1], P, dlogits[:, -1, :], c.c)
                for _ in range(self.grow_per_round):
                    tr, dcache = self._expand(dparams, tr, dcache)
                plan = self._select_plan(tr)
        if self.runs_target:
            with self._target():
                _, tcache = self.target.prefill(tparams, _to_device(prompt, self.device),
                                                S_max=self.S_max_t)
        return EngineState(tcache, dcache, tr, plan)

    def init_state(self, B: int) -> EngineState:
        """Empty B-slot serving state: zero caches, parked (invalid) trees.
        Parked rows are inert: their plans hold no valid node, so verify
        writes nothing for them and expansion skips them; the runtime
        discards whatever they "emit"."""
        self._fork()
        tcache = dcache = tr = plan = None
        if self.runs_target:
            with self._target():
                tcache = self.target.init_cache(B, self.S_max_t)
        if self.runs_draft:
            with self._draft():
                dcache = self.draft.init_cache(B, self.S_max_d)
                tr = T.init_tree(self.cfg.n_cap, B, self.device)
                plan = self._select_plan(tr)
        return EngineState(tcache, dcache, tr, plan)

    def session(self, tparams, dparams, *, state: EngineState | None = None,
                n_slots: int | None = None, tracer=None,
                track: str = "engine") -> "EngineSession":
        """Bind params (+ optional state and tracer) into an ``EngineSession``;
        ``n_slots`` starts it from an empty parked serving state."""
        check_frozen(tparams, dparams)
        if state is None and n_slots is not None:
            state = self.init_state(n_slots)
        return EngineSession(engine=self, tparams=tparams, dparams=dparams, state=state,
                             tracer=tracer if tracer is not None else NULL_TRACER, track=track)

    def profile(self, tparams, dparams, prompt, iters: int = 3) -> ProfileResult:
        """Paper §5.5 profile pass: wall-time one draft expansion and one
        target verification (+ compaction), each warmed first.  On a split
        each role times its own on its ranks, and the two leaders' times are
        exchanged once, so that every rank picks the same depth."""
        state = self._prefill_state(tparams, dparams, prompt)
        self._join()  # the passes below run on the caller's stream
        tr, dcache, tcache = state.tr, state.dcache, state.tcache
        plan = self._plan_to_target(state.plan, prompt.shape[0])

        def draft_once():
            nonlocal tr, dcache
            tr, dcache = self._expand(dparams, tr, dcache)
            _sync(self.device)

        def target_once():
            nonlocal tcache
            out = self._verify(tparams, tcache, plan)
            tcache = self._compact(out[5], *out[6])
            _sync(self.device)

        t_d = t_t = 0.0
        if self.runs_target:
            target_once()  # warm
        if self.runs_draft:
            t0 = monotonic()
            for _ in range(iters):
                draft_once()
            t_d = (monotonic() - t0) / iters
        if self.runs_target:
            t0 = monotonic()
            for _ in range(iters):
                target_once()
            t_t = (monotonic() - t0) / iters
        if self.split is not None:
            t_d, t_t = self.split.agree_times(t_d, t_t)
        return ProfileResult(t_draft_s=t_d, t_target_s=t_t)

    def _bypass(self, plan):
        """Straggler mitigation: degenerate to root-only verification."""
        keep = torch.arange(plan.tokens.shape[1], device=self.device) == 0
        return T.BatchPlan(
            node_ids=plan.node_ids,
            tokens=plan.tokens,
            rows=torch.where(keep[None, :], plan.rows, -1),
            positions=plan.positions,
            mask=plan.mask & keep[None, :, None],
            parent_pos=plan.parent_pos,
            valid=plan.valid & keep[None, :],
        )


@dataclasses.dataclass
class EngineSession:
    """Params + state + tracer bound into one decode session — the round
    API.

    Lockstep (``async_rounds=False``)::

        res = session.step()          # verify, expand, sync, reroot/grow

    Pipelined (``async_rounds=True``)::

        rif = session.begin_round()   # dispatch_verify + draft_next_tree
        res = session.reconcile(rif)  # sync, adopt lookahead or roll back

    Between ``begin_round`` and ``reconcile`` the round owns the state:
    ``admit_slot``/``release_slot``/``step``/``dispatch_verify`` raise until
    it is reconciled."""

    engine: SpecEngine
    tparams: Any
    dparams: Any
    state: EngineState | None = None
    tracer: Any = NULL_TRACER
    track: str = "engine"
    _inflight: RoundInFlight | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------
    # slot lifecycle
    # ------------------------------------------------------------------
    def admit_slot(self, slot: int, prompt) -> None:
        """Admit one request into batch row ``slot``: prefill it solo
        ([1, P], the numerics of a solo generate() start), install its cache
        rows into row ``slot`` of both serving caches, re-seed its tree row
        and grow and re-plan the batch.  Other rows keep their caches and
        trees (they may gain draft expansions, which never changes emitted
        tokens).  ``slot`` and ``P`` are host ints: nothing waits for the
        card.  On a split each role admits into its own cache (and the
        draft its tree); nothing crosses."""
        self._check_quiescent("admit_slot")
        eng, state, c = self.engine, self.state, self.engine.cfg
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        P = prompt.shape[1]
        tcache, dcache, tr, plan = state.tcache, state.dcache, state.tr, state.plan
        eng._fork()
        if eng.runs_draft:
            with eng._draft():
                dlogits, dcache1 = eng.draft.prefill(self.dparams, _to_device(prompt, eng.device),
                                                     S_max=eng.S_max_d)
        if eng.runs_target:
            with eng._target():
                _, tcache1 = eng.target.prefill(self.tparams, _to_device(prompt, eng.device),
                                                S_max=eng.S_max_t)
                tcache = kvm.install_slot(tcache, tcache1, slot)
        if eng.runs_draft:
            with eng._draft():
                dcache = kvm.install_slot(dcache, dcache1, slot)
                tr = T.seed_slot(tr, slot, int(prompt[0, -1]), P, dlogits[0, -1, :], c.c)
                for _ in range(eng.grow_per_round):
                    tr, dcache = eng._expand(self.dparams, tr, dcache)
                plan = eng._select_plan(tr)
        self.state = EngineState(tcache, dcache, tr, plan)

    def release_slot(self, slot: int) -> None:
        """Retire batch row ``slot``: park its tree row and zero its KV rows
        in both caches, so nothing leaks into the next occupant."""
        self._check_quiescent("release_slot")
        eng, state = self.engine, self.state
        tcache, dcache, tr, plan = state.tcache, state.dcache, state.tr, state.plan
        eng._fork()
        if eng.runs_target:
            with eng._target():
                tcache = kvm.zero_slot(tcache, slot)
        if eng.runs_draft:
            with eng._draft():
                dcache = kvm.zero_slot(dcache, slot)
                tr = T.reset_slot(tr, slot)
                plan = eng._select_plan(tr)
        self.state = EngineState(tcache, dcache, tr, plan)

    def _batch(self) -> int:
        """The state's batch rows (from the tree, or a target rank's cache)."""
        st = self.state
        return st.tr.tokens.shape[0] if st.tr is not None else kvm.batch_size(st.tcache)

    # ------------------------------------------------------------------
    # the round, lockstep
    # ------------------------------------------------------------------
    def step(self, stats: SpecStats | None = None, depth: int | None = None) -> StepResult:
        """One round for every batch row.  ``depth``: this round's draft
        depth as a host loop count (None: the config's ``d``).  With
        ``async_rounds`` this is the degenerate pipeline (``begin_round``
        then ``reconcile`` at once: the same tokens); the serving runtime
        splits the two calls.

        Records the reference's phase spans (verify_dispatch / kv_move /
        draft_expand / sync_emitted / reroot_grow) on ``track``.  The span
        times are host enqueue times except ``sync_emitted``, which waits
        for the card.  On a split the plan crosses first and the verdict
        in ``sync_emitted``; a rank's spans time its own role's work."""
        if self.engine.cfg.async_rounds:
            return self.reconcile(self.begin_round(depth=depth), stats=stats)
        self._check_quiescent("step")
        eng, obs, track = self.engine, self.tracer, self.track
        c, state = eng.cfg, self.state
        d_eff = _effective_depth(depth, c.d)
        B = self._batch()
        plan = eng._bypass(state.plan) if c.draft_bypass and eng.runs_draft else state.plan
        plan = eng._plan_to_target(plan, B)  # a split's plan: before the draft's expansions
        tr, dcache, tcache = state.tr, state.dcache, state.tcache
        draft_steps, verify = 0, None
        # --- verification on the target -------------------------------------
        with obs.span("verify_dispatch", track):
            if eng.runs_target:
                *verify, tcache, mv = eng._verify(self.tparams, tcache, plan)
                with obs.span("kv_move", track):
                    tcache = eng._compact(tcache, *mv)
        # --- d tree expansions on the draft (queued behind verify) -----------
        if c.mode == "parallel":
            with obs.span("draft_expand", track):
                if eng.runs_draft:
                    for _ in range(d_eff):
                        tr, dcache = eng._expand(self.dparams, tr, dcache)
            draft_steps += d_eff
        # --- sync point: the verified tokens reach the host -----------------
        with obs.span("sync_emitted", track):
            buf, verify = eng._verdict(verify, B)
            # the round's ONE designated host sync: one fused transfer (on a
            # split, of the broadcast verdict)
            if buf is None:
                host = pack((verify[1], *verify[3:])).cpu().numpy()  # n_acc, emitted, n_emitted
                n_acc_h, emitted_h, n_emitted_h = unpack(host, (1, c.bs + 1, 1))
            else:
                _, n_acc_h, _, emitted_h, n_emitted_h = unpack(buf.cpu().numpy(),
                                                               verdict_widths(c.bs))
        # --- re-root, fill, grow, select next batch (draft) -------------------
        new_plan = None
        n_grow = d_eff if c.mode == "serial" else eng.grow_per_round
        with obs.span("reroot_grow", track):
            if eng.runs_draft:
                acc_pos, n_acc, bonus = verify[:3]
                tr, move, fillp = T.reroot(tr, plan.node_ids, acc_pos, n_acc, bonus)
                with obs.span("kv_move", track):
                    dcache = eng._kv_move(dcache, move.src, move.dst, move.mask)
                dcache = eng._fill(self.dparams, dcache, fillp)
                for _ in range(n_grow):
                    tr, dcache = eng._expand(self.dparams, tr, dcache)
                new_plan = eng._select_plan(tr)
            draft_steps += n_grow
        self.state = EngineState(tcache, dcache, tr, new_plan)
        if stats is not None:
            stats.add_round(n_emitted_h, n_acc_h)
            stats.draft_steps += draft_steps
        return StepResult(emitted_h, n_emitted_h, n_acc_h)

    # ------------------------------------------------------------------
    # the round, disaggregated (async_rounds)
    # ------------------------------------------------------------------
    def begin_round(self, depth: int | None = None) -> RoundInFlight:
        """Dispatch one full round without a host sync: verify on the
        target's stream, then the speculative next-round draft on the
        draft's.  ``depth``: this round's draft depth (see ``step``)."""
        return self.draft_next_tree(self.dispatch_verify(), depth=depth)

    def dispatch_verify(self) -> RoundInFlight:
        """Enqueue this round's verification and compaction.  The
        ``verify_dispatch`` span stays open until the reconcile sync, so on
        the trace it is the verify window and its overlap with
        ``draft_lookahead`` can be read off.  On a split the plan crosses
        here, draft -> target."""
        self._check_quiescent("dispatch_verify")
        eng, state = self.engine, self.state
        B = self._batch()
        eng._fork()
        plan = state.plan
        with eng._draft():  # plan preparation is draft-side work
            if eng.cfg.draft_bypass and eng.runs_draft:
                plan = eng._bypass(plan)
        if eng.streams:  # the plan was built on the draft stream
            eng.streams[0].wait_stream(eng.streams[1])
        plan = eng._plan_to_target(plan, B)
        span = self.tracer.begin("verify_dispatch", self.track)
        tcache, verify = state.tcache, None
        if eng.runs_target:
            with eng._target():
                *verify, tcache, mv = eng._verify(self.tparams, tcache, plan)
                with self.tracer.span("kv_move", self.track):
                    tcache = eng._compact(tcache, *mv)
        rif = RoundInFlight(plan=plan, tcache=tcache,
                            verify=None if verify is None else tuple(verify), verify_span=span)
        self._inflight = rif
        return rif

    def draft_next_tree(self, rif: RoundInFlight, depth: int | None = None) -> RoundInFlight:
        """While verify runs: finish this round's ``depth`` expansions,
        predict the accept path (``tree.predict_accept``) and draft round
        N+1's tree on the predicted seed.  The post-expansion (tr, dcache)
        is kept as the rollback snapshot: the speculative re-root moves rows
        into a fresh cache, and the fill and regrowth write only that one.
        A target rank of a split only counts the draft's steps."""
        eng, c = self.engine, self.engine.cfg
        d_eff = _effective_depth(depth, c.d)
        rif.draft_steps += d_eff + eng.grow_per_round
        if not eng.runs_draft:
            return rif
        tr, dcache = self.state.tr, self.state.dcache
        with self.tracer.span("draft_lookahead", self.track), eng._draft():
            for _ in range(d_eff):
                tr, dcache = eng._expand(self.dparams, tr, dcache)
            rif.snapshot = (tr, dcache)  # post-expansion, pre-reroot: the rollback point
            rif.pred = eng._predict(tr, rif.plan.node_ids, rif.plan.parent_pos, rif.plan.valid)
            if eng.streams:
                rif.pred_ready = torch.cuda.Event()
                rif.pred_ready.record(eng.streams[1])
            la_tr, move, fillp = T.reroot(tr, rif.plan.node_ids, *rif.pred)
            with self.tracer.span("kv_move", self.track):
                la_dcache = eng._spec_kv_move(dcache, move.src, move.dst, move.mask)
            la_dcache = eng._fill(self.dparams, la_dcache, fillp)
            for _ in range(eng.grow_per_round):
                la_tr, la_dcache = eng._expand(self.dparams, la_tr, la_dcache)
            rif.lookahead = (la_tr, la_dcache, eng._select_plan(la_tr))
        return rif

    def reconcile(self, rif: RoundInFlight, stats: SpecStats | None = None,
                  live=None) -> StepResult:
        """Make the round's one host sync and resolve the speculation: adopt
        the lookahead when the predicted accept path held for every live
        row, else roll back to the snapshot and re-root on the actual path
        (the lockstep tail, one round late).  ``live``: optional bool[B]
        occupancy — mismatches on parked rows are ignored.  Emitted tokens
        always come from the actual verify, so both branches emit the
        lockstep bytes.  On a split the verdict and the prediction cross
        here, and every rank takes the same ``ok`` from the one transfer."""
        eng, obs, track = self.engine, self.tracer, self.track
        bs = eng.cfg.bs
        B = rif.plan.tokens.shape[0]
        with obs.span("sync_emitted", track), eng._target():
            if rif.pred_ready is not None:
                eng.streams[0].wait_event(rif.pred_ready)
            vbuf, verify = eng._verdict(rif.verify, B)
            pbuf = eng._prediction(rif.pred, B)
            # the round's ONE designated host sync: verified tokens and the
            # prediction cross in a single fused transfer
            fused = (pack(verify + rif.pred) if vbuf is None else
                     torch.cat([vbuf, pbuf], dim=1))
            host = fused.cpu().numpy()
        rif.verify_span.end()
        (acc_h, n_acc_h, bonus_h, emitted_h, n_emitted_h, pred_acc_h, pred_n_h,
         pred_bonus_h) = unpack(host, verdict_widths(bs) + pred_widths(bs))
        ok = (pred_n_h == n_acc_h) & (pred_bonus_h == bonus_h) & (pred_acc_h == acc_h).all(axis=1)
        if live is not None:
            ok = ok | ~np.asarray(live, bool)
        draft_steps = rif.draft_steps
        tr = dcache = new_plan = None
        if ok.all():
            # the seed held for every live row: round N+1's tree is drafted
            if eng.runs_draft:
                tr, dcache, new_plan = rif.lookahead
            if stats is not None:
                stats.spec_commits += 1
        else:
            acc_pos, n_acc, bonus = verify[:3]
            if eng.streams:  # the draft stream reads the verify outcome
                eng.streams[1].wait_stream(eng.streams[0])
                for t in (acc_pos, n_acc, bonus):
                    t.record_stream(eng.streams[1])
            with obs.span("reconcile", track), eng._draft():
                if eng.runs_draft:
                    tr, dcache = rif.snapshot
                    tr, move, fillp = T.reroot(tr, rif.plan.node_ids, acc_pos, n_acc, bonus)
                    with obs.span("kv_move", track):
                        # the actual-path move consumes the snapshot, in place
                        dcache = eng._kv_move(dcache, move.src, move.dst, move.mask)
                    dcache = eng._fill(self.dparams, dcache, fillp)
                    for _ in range(eng.grow_per_round):
                        tr, dcache = eng._expand(self.dparams, tr, dcache)
                    new_plan = eng._select_plan(tr)
            draft_steps += eng.grow_per_round
        self.state = EngineState(rif.tcache, dcache, tr, new_plan)
        self._inflight = None
        if stats is not None:
            stats.spec_rounds += 1
            stats.add_round(n_emitted_h, n_acc_h)
            stats.draft_steps += draft_steps
        return StepResult(emitted_h, n_emitted_h, n_acc_h)

    def generate(self, prompt, max_new=None):
        """prompt: np.ndarray [B, P] int32.  Returns (tokens [B, <=max_new]
        list, stats).  Rebuilds the session state from a whole-batch prefill
        of ``prompt``, then loops rounds."""
        eng, c = self.engine, self.engine.cfg
        max_new = max_new or c.max_new
        prompt = np.asarray(prompt, np.int32)
        B, P = prompt.shape
        t0 = monotonic()

        self.state = eng._prefill_state(self.tparams, self.dparams, prompt)
        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        stats = SpecStats()
        rounds_cap = max_new + 2  # greedy emits >=1 token/round

        for _ in range(rounds_cap):
            longest = 0 if stats.emitted_rows is None else int(stats.emitted_rows.max())
            if done.all() or (P + longest) >= eng.plen_budget:
                break
            res = self.step(stats=stats)
            for b in range(B):
                if not done[b]:
                    _, done[b] = absorb_emitted(
                        out[b], res.emitted[b], res.n_emitted[b], max_new, c.eos_id)

        stats.wall_s = monotonic() - t0
        return out, stats

    def _check_quiescent(self, what: str) -> None:
        if self._inflight is not None:
            raise RuntimeError(
                f"EngineSession.{what} called with a round in flight; "
                "reconcile() the outstanding RoundInFlight first — the round "
                "owns the session state until then")
