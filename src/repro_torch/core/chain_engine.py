"""Chain-mode speculative decoding for recurrent-state architectures
(``repro.core.chain_engine``; SSM / hybrid: zamba2, rwkv6, and dense
pairs).

Tree speculation does not fit a recurrent state (the tree's branches cannot
share one sequential state), so speculation runs on chains, with the
paper's asynchronous draft/target split kept:

  * the draft proposes k tokens greedily from a snapshot of its state
    (``decode_step`` k times; that advance is thrown away);
  * the target verifies the chain in one forward (``chain_forward`` with
    n_commit = 0: logits teacher-forced, recurrent state untouched), then
    commits exactly the emitted prefix — an attention-only target by moving
    ``len`` (its rows are written), a state-bearing one by recomputing
    from the pre-round cache;
  * after partial acceptance the draft recomputes from its pre-round
    snapshot (one chain forward of the emitted tokens);
  * in parallel mode the draft's next chain is drafted while the target
    verifies, on the all-accepted assumption, and kept when it holds.

The snapshot.  The reference's caches are immutable, so its snapshot is
free.  Here the forwards write K/V rows in place, but only rows at or past
``len`` (dead until committed) and the mamba2 and rwkv6 blocks return new
state tensors and never write their input's (``models/mamba2.py``,
``models/rwkv6.py``): a cache kept from before a forward keeps its state
and its live rows, whatever runs from it.  No cache is cloned.

On the card, in parallel mode, the target's work runs on one CUDA stream
and the draft's on another (as the tree engine's async round,
``core/engine.py``); tensors cross at the chain ``u`` (draft -> target, an
event after it is built) and at the round's one host transfer.  Serial mode
runs on the caller's stream.  Each round makes exactly one host sync: the
verified argmax and the draft chain in one transfer.  The next round's
first token, like the prompt, reaches the card by a non-blocking copy from
pinned memory, so a request adds one sync of its own: its first token.

Disaggregated (``split=``, ``parallel/split.py``): target and draft on
disjoint rank groups, one process per rank, each rank its own role's
forwards and caches.  Three tensors cross, each one world broadcast: the
request's first token (target -> every rank), then each round the chain
(``pending`` and the k drafts, draft -> target) and the target's argmax
(target -> every rank).  In parallel mode the draft enqueues its lookahead
before it waits for the argmax.  Every rank makes the round's one host
transfer of the argmax and the drafts and takes the same ``n_acc``,
``full`` and commit from it.

Tensor parallel (both models sharded over the same ranks, ``group=`` of
``models.api.make_model``): every rank runs the whole round on its shards,
and every host decision (``n_acc``, ``full``, the commit) comes from the
argmax of logits that the group gathered, so it is the same on every rank.
Parallel mode refuses a draft that shares the target's process group, on
any device: on the card its collectives would be issued from the draft's
stream beside the target's on one communicator.

Greedy-equality invariant: the emitted tokens equal target-only greedy
decoding.  One request at a time (B = 1), the paper's latency regime.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import StreamPair, _to_device, check_frozen, engine_device
from repro_torch.obs.clock import monotonic
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    k: int = 6  # draft chain length per round
    mode: str = "parallel"  # "parallel" | "serial"
    max_new: int = 64
    eos_id: int = -1


@dataclasses.dataclass
class ChainStats:
    rounds: int = 0
    emitted: int = 0
    accepted: int = 0
    reused_chains: int = 0
    draft_chains: int = 0
    wall_s: float = 0.0

    @property
    def compression_ratio(self) -> float:
        return self.emitted / max(self.rounds, 1)


def _has_state(model) -> bool:
    return any(k in ("mamba2", "rwkv6") for k in model.cfg.layer_kinds)


class ChainSpecEngine(StreamPair):
    def __init__(self, target, draft, cfg: ChainConfig, S_max_t: int, S_max_d: int,
                 target_devices=None, draft_devices=None, split=None):
        self.device = engine_device(target, draft, target_devices, draft_devices, split)
        if cfg.mode not in ("parallel", "serial"):
            raise ValueError(f"mode must be 'parallel' or 'serial', got {cfg.mode!r}")
        self.target, self.draft, self.cfg = target, draft, cfg
        self.S_max_t, self.S_max_d = S_max_t, S_max_d
        self.split = split
        # parallel mode on the card: the target's stream and the draft's (a
        # split rank runs one role)
        self.streams = None
        if cfg.mode == "parallel" and split is None and target.group is not None and \
                target.group.world > 1 and target.group.pg is draft.group.pg:
            raise ValueError(
                "parallel mode on the card issues the target's and the draft's collectives "
                "from two streams: give each model a process group of its own over the same "
                "ranks (TPGroup.new_group)")
        if cfg.mode == "parallel" and self.device.type == "cuda" and split is None:
            self.streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))

    # ----- the round's programs (the reference's jitted functions) ----------
    def _draft_chain(self, dparams, dcache, first_tok):
        """k greedy draft tokens [B, k] from ``dcache`` (left as it was but
        for dead rows past its length)."""
        toks, tok = [], first_tok
        for _ in range(self.cfg.k):
            logits, dcache = self.draft.decode_step(dparams, dcache, tok, self.S_max_d)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    def _verify(self, tparams, tcache, u):
        """One target forward over the chain; no state committed."""
        logits, tcache_rows = self.target.chain_forward(tparams, tcache, u, 0, self.S_max_t)
        return logits.argmax(-1).to(torch.int32), tcache_rows

    def _tcommit(self, tparams, tcache, u, n):
        return self.target.chain_forward(tparams, tcache, u, n, self.S_max_t)[1]

    def _dcommit(self, dparams, dcache, u, n):
        return self.draft.chain_forward(dparams, dcache, u, n, self.S_max_d)[1]

    def _tprefill(self, tparams, prompt):
        return self.target.prefill(tparams, prompt, S_max=self.S_max_t)

    def _dprefill(self, dparams, prompt):
        return self.draft.prefill(dparams, prompt, S_max=self.S_max_d)

    # ------------------------------------------------------------------
    def session(self, tparams, dparams, *, tracer=None, track="chain") -> "ChainSession":
        """Bind params (+ optional tracer) into a ChainSession."""
        check_frozen(tparams, dparams)
        return ChainSession(self, tparams, dparams, tracer=tracer or NULL_TRACER, track=track)


@dataclasses.dataclass
class ChainSession:
    """Params bound to a ChainSpecEngine.  ``generate`` emits the tree
    engine's span names (``round``; ``draft_expand``; ``verify_dispatch``
    held open until the verified tokens reach the host, so it is the verify
    window that ``draft_lookahead`` overlaps; ``sync_emitted`` around the
    round's one host transfer; ``reroot_grow`` for the commit)."""

    engine: ChainSpecEngine
    tparams: Any
    dparams: Any
    tracer: Any = NULL_TRACER
    track: str = "chain"

    def generate(self, prompt, max_new=None):
        """prompt: int [1, P].  Returns ([tokens], ChainStats)."""
        eng, c, obs, track = self.engine, self.engine.cfg, self.tracer, self.track
        tparams, dparams = self.tparams, self.dparams
        k = c.k
        max_new = max_new or c.max_new
        prompt = np.asarray(prompt, np.int32)
        B, P = prompt.shape
        if B != 1:
            raise ValueError(f"the chain engine takes one request at a time, got B={B}")
        t0 = monotonic()

        eng._fork()
        tcache = dcache = first_t = None
        with eng._target():
            if eng.runs_target:
                tlogits, tcache = eng._tprefill(tparams, _to_device(prompt, eng.device))
                first_t = tlogits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            first_t = eng._share(first_t, "target", (1, 1))
            first = int(first_t[0, 0])  # the request's first token: its one extra sync
        if eng.runs_draft:
            with eng._draft():
                _, dcache = eng._dprefill(dparams, _to_device(prompt, eng.device))
                pending = _to_device([[first]], eng.device)  # [1, 1]
        out = [first]
        stats = ChainStats(emitted=1)
        t_state = _has_state(eng.target)
        reuse = False  # the speculated next chain (parallel) is drafted and held
        pre_drafts = None  # that chain, on the draft's ranks
        done = (c.eos_id >= 0 and first == c.eos_id) or len(out) >= max_new

        while not done:
            if (P + stats.emitted + 2 * k + 2) >= min(eng.S_max_t, eng.S_max_d):
                break
            rspan = obs.begin("round", track)
            dsnap = dcache  # pre-round draft cache: the forwards below keep it

            # --- draft chain ------------------------------------------------
            chain = u_ready = None
            with obs.span("draft_expand", track), eng._draft():
                if reuse:
                    drafts = pre_drafts
                    stats.reused_chains += 1
                else:
                    drafts = eng._draft_chain(dparams, dcache, pending) if eng.runs_draft \
                        else None
                    stats.draft_chains += 1
                if eng.runs_draft:
                    chain = torch.cat([pending, drafts], dim=1)  # [1, 1 + k]
                    if eng.streams:
                        u_ready = torch.cuda.Event()
                        u_ready.record()
            chain = eng._share(chain, "draft", (1, 1 + k))  # a split's chain: draft -> target
            u, drafts = chain[:, :k], chain[:, 1:]

            # --- target verification: the span stays open until the verified
            # tokens reach the host (the verify window)
            vspan = obs.begin("verify_dispatch", track)
            argmax = None
            if eng.runs_target:
                with eng._target():
                    if u_ready is not None:
                        torch.cuda.current_stream().wait_event(u_ready)
                        # read on this stream too (u and drafts are its views), for the allocator
                        chain.record_stream(torch.cuda.current_stream())
                    argmax, tcache_rows = eng._verify(tparams, tcache, u)

            # --- meanwhile: draft the next chain on the all-accepted guess -----
            if c.mode == "parallel":
                with obs.span("draft_lookahead", track), eng._draft():
                    if eng.runs_draft:
                        dfull = eng._dcommit(dparams, dsnap, u, k)
                        nxt_drafts = eng._draft_chain(dparams, dfull, drafts[:, k - 1:])
                    stats.draft_chains += 1

            # --- the round's one host sync ---------------------------------------
            with obs.span("sync_emitted", track), eng._target():
                argmax = eng._share(argmax, "target", (1, k))  # a split's verdict: to every rank
                host = torch.cat([argmax, drafts], dim=1).cpu().numpy()[0]
            vspan.end()
            argmax_h, drafts_h = host[:k], host[k:]
            n_acc = 0
            while n_acc < k - 1 and drafts_h[n_acc] == argmax_h[n_acc]:
                n_acc += 1
            n_emit = n_acc + 1

            for t in argmax_h[:n_emit].tolist():
                out.append(int(t))
                if (c.eos_id >= 0 and t == c.eos_id) or len(out) >= max_new:
                    done = True
                    break
            stats.rounds += 1
            stats.accepted += n_acc
            stats.emitted += n_emit
            full = n_acc == k - 1 and argmax_h[k - 1] == drafts_h[k - 1]
            reuse = full and c.mode == "parallel"

            # --- commit the emitted prefix --------------------------------------
            with obs.span("reroot_grow", track):
                if eng.runs_target:
                    with eng._target():
                        if t_state:
                            tcache = eng._tcommit(tparams, tcache, u, n_emit)
                        else:  # attention-only: the rows are written, move len
                            tcache = {**tcache_rows, "len": tcache_rows["len"] + n_emit}
                if eng.runs_draft:
                    with eng._draft():
                        pending = _to_device([[argmax_h[n_emit - 1]]], eng.device)
                        if reuse:
                            dcache = dfull  # the chain held: snapshot + u is the truth
                            pre_drafts = nxt_drafts
                        else:
                            dcache = eng._dcommit(dparams, dsnap, u, n_emit)
                            pre_drafts = None
            rspan.end()

        eng._join()
        stats.wall_s = monotonic() - t0
        return [out[:max_new]], stats
