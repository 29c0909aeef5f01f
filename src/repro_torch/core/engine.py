"""SpecEngine — tree-based speculative decoding, lockstep round
(``repro.core.engine``; paper §3.1, Algorithm 1).

One round (``EngineSession.step``): verify the draft tree on the target and
walk it greedily, compact the target cache, run ``d`` draft expansions,
make the round's one host sync, re-root the tree and move the draft-cache
rows, fill the prefix KV, grow the tree, select the next verify batch.
``mode="serial"`` is the SwiftSpec-base baseline (the d expansions run after
verification instead of beside it).

Target and draft share one device in this slice; PyTorch's asynchronous
CUDA launches play the role of JAX's async dispatch — nothing waits for the
card until the fused ``(emitted, n_emitted, n_acc)`` transfer.  Every cache
the round touches is written in place (``core/kv.py``).

Greedy-verification invariant: the emitted stream equals target-only greedy
decoding token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import kv as kvm
from repro_torch.core import tree as T
from repro_torch.core.scheduler import ProfileResult
from repro_torch.obs.clock import monotonic
from repro_torch.obs.trace import NULL_TRACER


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


@dataclasses.dataclass
class SpecStats:
    """Per-row exact accounting: ``emitted_rows``/``accepted_rows`` hold one
    running total per batch row; the scalar views are per-row means."""

    rounds: int = 0
    draft_steps: int = 0
    wall_s: float = 0.0
    emitted_rows: np.ndarray | None = None  # i64[B] per-row emitted totals
    accepted_rows: np.ndarray | None = None  # i64[B] per-row accepted totals

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
    writes the caches in place and replaces the tree and plan."""

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


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SpecEngine:
    """Tree-based speculative decoding for dense attention models."""

    def __init__(self, target, draft, cfg: SpecConfig, S_max_t: int, S_max_d: int):
        if target.device != draft.device:
            raise ValueError(f"target ({target.device}) and draft ({draft.device}) share "
                             "one device in this slice")
        self.target, self.draft, self.cfg = target, draft, cfg
        self.S_max_t, self.S_max_d = S_max_t, S_max_d
        self.device = target.device

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
        """Whole-batch prefill + tree seed + initial growth."""
        c = self.cfg
        B, P = prompt.shape
        dlogits, dcache = self.draft.prefill(dparams, prompt, S_max=self.S_max_d)
        _, tcache = self.target.prefill(tparams, prompt, S_max=self.S_max_t)
        tr = T.init_tree(c.n_cap, B, self.device)
        root_tok = torch.as_tensor(prompt[:, -1], dtype=torch.int32, device=self.device)
        tr = T.seed_root(tr, root_tok, P, dlogits[:, -1, :], c.c)
        for _ in range(self.grow_per_round):
            tr, dcache = self._expand(dparams, tr, dcache)
        return EngineState(tcache, dcache, tr, self._select_plan(tr))

    def session(self, tparams, dparams, *, state: EngineState | None = None,
                tracer=None, track: str = "engine") -> "EngineSession":
        """Bind params (+ optional state and tracer) into an ``EngineSession``."""
        return EngineSession(engine=self, tparams=tparams, dparams=dparams, state=state,
                             tracer=tracer if tracer is not None else NULL_TRACER, track=track)

    def profile(self, tparams, dparams, prompt, iters: int = 3) -> ProfileResult:
        """Paper §5.5 profile pass: wall-time one draft expansion and one
        target verification (+ compaction), each warmed first."""
        state = self._prefill_state(tparams, dparams, prompt)
        tr, dcache, tcache, plan = state.tr, state.dcache, state.tcache, state.plan

        def draft_once():
            nonlocal tr, dcache
            tr, dcache = self._expand(dparams, tr, dcache)
            _sync(self.device)

        def target_once():
            nonlocal tcache
            out = self._verify(tparams, tcache, plan)
            tcache = self._compact(out[5], *out[6])
            _sync(self.device)

        target_once()  # warm
        t0 = monotonic()
        for _ in range(iters):
            draft_once()
        t_d = (monotonic() - t0) / iters
        t0 = monotonic()
        for _ in range(iters):
            target_once()
        t_t = (monotonic() - t0) / iters
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
    API (``res = session.step()``; ``session.generate(prompt)``)."""

    engine: SpecEngine
    tparams: Any
    dparams: Any
    state: EngineState | None = None
    tracer: Any = NULL_TRACER
    track: str = "engine"

    def step(self, stats: SpecStats | None = None, depth: int | None = None) -> StepResult:
        """One lockstep round for every batch row.  ``depth``: this round's
        draft depth as a host loop count (None: the config's ``d``).

        Records the reference's phase spans (verify_dispatch / kv_move /
        draft_expand / sync_emitted / reroot_grow) on ``track``.  The span
        times are host enqueue times except ``sync_emitted``, which waits
        for the card."""
        eng, obs, track = self.engine, self.tracer, self.track
        c, state = eng.cfg, self.state
        d_eff = _effective_depth(depth, c.d)
        plan = eng._bypass(state.plan) if c.draft_bypass else state.plan
        tr, dcache = state.tr, state.dcache
        draft_steps = 0
        # --- verification on the target -------------------------------------
        with obs.span("verify_dispatch", track):
            acc_pos, n_acc, bonus, emitted, n_emitted, tcache, mv = eng._verify(
                self.tparams, state.tcache, plan)
            with obs.span("kv_move", track):
                tcache = eng._compact(tcache, *mv)
        # --- d tree expansions on the draft (queued behind verify) -----------
        if c.mode == "parallel":
            with obs.span("draft_expand", track):
                for _ in range(d_eff):
                    tr, dcache = eng._expand(self.dparams, tr, dcache)
                draft_steps += d_eff
        # --- sync point: the verified tokens reach the host -----------------
        with obs.span("sync_emitted", track):
            # the round's ONE designated host sync: one fused transfer
            host = torch.cat([emitted, n_emitted[:, None], n_acc[:, None]], dim=1).cpu().numpy()
        bs1 = emitted.shape[1]
        emitted_h, n_emitted_h, n_acc_h = host[:, :bs1], host[:, bs1], host[:, bs1 + 1]
        # --- re-root, fill, grow, select next batch (draft) -------------------
        with obs.span("reroot_grow", track):
            tr, move, fillp = T.reroot(tr, plan.node_ids, acc_pos, n_acc, bonus)
            with obs.span("kv_move", track):
                dcache = eng._kv_move(dcache, move.src, move.dst, move.mask)
            dcache = eng._fill(self.dparams, dcache, fillp)
            n_grow = d_eff if c.mode == "serial" else eng.grow_per_round
            for _ in range(n_grow):
                tr, dcache = eng._expand(self.dparams, tr, dcache)
            draft_steps += n_grow
            new_plan = eng._select_plan(tr)
        self.state = EngineState(tcache, dcache, tr, new_plan)
        if stats is not None:
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
