"""The disaggregated tree engine: target and draft on disjoint gloo rank
groups on the CPU (``repro_torch.parallel.split``), against the JAX
package's single-device ``SpecEngine`` on the same ``dense_pair`` weights.

Worlds of 1 + 1, 2 + 1 (the target sharded over two ranks) and 1 + 2 (the
draft over two), with the independent draft and the target drafting for
itself (a copy on the draft's ranks): lockstep (parallel and serial), async
rounds and ``draft_bypass`` must emit the reference's tokens with every
``SpecStats`` field equal, the target's own greedy decode, and the same on
every rank.  A round issues two world broadcasts (the plan, the verdict),
three with async rounds (and the prediction); a role of one rank issues no
other collective.  A rank holds nothing of the other role: its stand-in
has no tensor, its parameters are its own role's, and its session state
holds only its role's caches, tree and plan.  The packed plan is about
33 KB at B 2, bs 8, S 512 and round-trips field for field.  Crossed
exchanges deadlock, and ``run_ranks``'s time limit ends them.
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the tier-1 CI job installs no torch
torch.set_num_threads(2)  # beside the other test workers and the reference's wall-clock gates

from conftest import greedy_reference
from repro.core.engine import SpecConfig as JSpecConfig
from repro.core.engine import SpecEngine as JSpecEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import tree as T
from repro_torch.core.engine import SpecConfig, SpecEngine, pack, unpack, verdict_widths
from repro_torch.models.api import StandIn, make_model
from repro_torch.parallel.group import TPGroup
from repro_torch.parallel.shard import Shard
from repro_torch.parallel.spawn import run_ranks
from repro_torch.parallel.split import Split, make_split
from test_torch_model import unbox

HERE = pathlib.Path(__file__).resolve().parent
S_MAX = 256
BASE = dict(bs=8, w=4, c=2, d=2, n_cap=64, max_new=24)
RUNS = {"lockstep": BASE, "serial": dict(BASE, mode="serial"),
        "async": dict(BASE, async_rounds=True), "bypass": dict(BASE, draft_bypass=True)}
PAIRS = ("pair", "self")
WORLDS = {"1+1": (1, 1), "2+1": (2, 1), "1+2": (1, 2)}
STATS = ("rounds", "draft_steps", "emitted_rows", "accepted_rows", "spec_rounds", "spec_commits")
SPAWN_S = 120


def _prompts():
    return [((np.arange(8, dtype=np.int32).reshape(1, 8) * 3 + 1 + 7 * i) % 128).astype(np.int32)
            for i in range(2)]


def _stats(st) -> dict:
    return {"rounds": st.rounds, "draft_steps": st.draft_steps,
            "emitted_rows": st.emitted_rows.tolist(), "accepted_rows": st.accepted_rows.tolist(),
            "spec_rounds": st.spec_rounds, "spec_commits": st.spec_commits}


@pytest.fixture(scope="module")
def reference(dense_pair):
    """(pair, run) -> (tokens per prompt, stats per prompt) of the
    reference's single-device engine; "greedy" -> its target's greedy
    decode of each prompt."""
    T_, D, tp, dp = dense_pair
    out = {"greedy": [greedy_reference(T_, tp, p, BASE["max_new"], S_MAX)[0] for p in _prompts()]}
    for pair in PAIRS:
        draft, dparams = (T_, tp) if pair == "self" else (D, dp)
        for run, kw in RUNS.items():
            sess = JSpecEngine(T_, draft, JSpecConfig(**kw), S_max_t=S_MAX,
                               S_max_d=S_MAX).session(tp, dparams)
            res = [sess.generate(p) for p in _prompts()]
            out[pair, run] = ([o[0] for o, _ in res], [_stats(s) for _, s in res])
    return out


def _cfgs(dense_pair):
    T_, D, _, _ = dense_pair
    return ModelConfig(**dataclasses.asdict(T_.cfg)), ModelConfig(**dataclasses.asdict(D.cfg))


@pytest.fixture(scope="module", params=list(WORLDS))
def ranks(request, dense_pair, tmp_path_factory):
    """(world name, pair -> the per-rank results of ``workers.split_engine``)."""
    _, _, tp, dp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    n_target, n_draft = WORLDS[request.param]
    job = {"n_target": n_target, "tcfg": tcfg, "prompts": _prompts(), "S_max": S_MAX,
           "runs": [(run, "tree", kw) for run, kw in RUNS.items()], "greedy_n": BASE["max_new"]}
    calls = [("split_engine", (dict(job, dcfg=dcfg, weights=("numpy", unbox(tp), unbox(dp))),)),
             ("split_engine", (dict(job, dcfg=None, weights=("numpy", unbox(tp), None)),))]
    res = run_ranks("repro_torch.parallel.workers:several", n_target + n_draft, (calls,),
                    workdir=tmp_path_factory.mktemp(f"split{n_target}{n_draft}"), device="cpu",
                    timeout_s=SPAWN_S)
    return request.param, {pair: [r[i] for r in res] for i, pair in enumerate(PAIRS)}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("pair", PAIRS)
def test_split_engine_emits_the_reference_tokens_and_stats(ranks, reference, pair, run):
    world, by_pair = ranks
    want_toks, want_stats = reference[pair, run]
    for res in by_pair[pair]:
        got = res["runs"][run]
        assert got["tokens"] == want_toks, f"{world} rank {res['rank']} ({res['role']})"
        assert [{k: g[k] for k in STATS} for g in got["stats"]] == want_stats


@pytest.mark.parametrize("pair", PAIRS)
def test_split_engine_equals_the_greedy_decode_on_every_rank(ranks, reference, pair):
    world, by_pair = ranks
    n_target = WORLDS[world][0]
    roles = [r["role"] for r in by_pair[pair]]
    assert roles == ["target"] * n_target + ["draft"] * WORLDS[world][1]
    first = by_pair[pair][0]
    for res in by_pair[pair]:
        if res["role"] == "target":  # the target's own greedy decode, on its ranks
            assert res["greedy"] == reference["greedy"]
        else:
            assert "greedy" not in res
        for run in RUNS:
            got = res["runs"][run]
            assert got["tokens"] == first["runs"][run]["tokens"]
            assert got["stats"] == first["runs"][run]["stats"]
            for toks, greedy in zip(got["tokens"], reference["greedy"]):
                assert toks == greedy[:len(toks)] and len(toks) == BASE["max_new"]
    if pair == "self":  # drafting for itself the engine accepts: every exchange carries rows
        assert sum(sum(s["accepted_rows"]) for s in first["runs"]["lockstep"]["stats"]) > 0
        assert sum(s["spec_commits"] for s in first["runs"]["async"]["stats"]) > 0


def test_split_engine_exchanges_the_plan_and_the_verdict_each_round(ranks):
    """Two world broadcasts a round (three with async rounds), none else on
    a role of one rank; a sharded role's forward adds its all-reduces."""
    world, by_pair = ranks
    for res in by_pair["pair"]:
        for run, got in res["runs"].items():
            per_round = 3 if run == "async" else 2
            assert got["collectives"]["broadcast"] == per_round * got["rounds"], (world, run)
            sharded = len(res["ranks"]) > 1
            assert (got["collectives"]["all_reduce"] > 0) == sharded, (world, res["rank"], run)


def test_a_rank_holds_nothing_of_the_other_role(ranks, dense_pair):
    """The stand-in holds no tensor; the rank's parameters are its own
    role's model (the whole one, or its shard of it); its session state
    holds its role's caches, tree and plan only."""
    world, by_pair = ranks
    _, _, tp, dp = dense_pair
    tcfg, dcfg = _cfgs(dense_pair)
    for pair in PAIRS:
        for res in by_pair[pair]:
            assert res["standin"] == {"is_standin": True, "tensors": 0}
            cfg, tree = (tcfg, tp) if res["role"] == "target" or pair == "self" else (dcfg, dp)
            whole = params_from_numpy(cfg, unbox(tree), "cpu")
            n = len(res["ranks"])
            mine = Shard(cfg, res["ranks"].index(res["rank"]), n).params(whole) if n > 1 else whole
            assert res["param_bytes"] == sum(p.numel() * p.element_size()
                                             for p in mine.parameters())
            target = res["role"] == "target"
            for run in RUNS:
                assert res["runs"][run]["holds"] == {"tcache": target, "dcache": not target,
                                                     "tr": not target, "plan": not target}


def _wire_world(wire: list, send: bool):
    """A stand-in world group on the CPU: a sender's ``broadcast`` puts its
    buffer on ``wire``, a receiver's takes the oldest one off it."""

    def broadcast(t, src):
        if send:
            wire.append(t.clone())
        else:
            t.copy_(wire.pop(0))
        return t

    return types.SimpleNamespace(ranks=(0, 1), rank=0 if send else 1, world=2,
                                 device=torch.device("cpu"), broadcast=broadcast)


def _fake_split(role, world):
    grp = TPGroup(pg=None, rank=0, world=1, device=torch.device("cpu"), backend="gloo",
                  ranks=(0,) if role == "target" else (1,))
    return Split(role, grp, world, (0,), (1,))


def test_the_packed_plan_and_verdict_round_trip():
    """The draft's plan crosses in one int32 buffer [B, 5 bs + bs S] (at B 2,
    bs 8, S 512: 33088 bytes) and comes out field for field; the verdict
    [B, 2 bs + 4] is 160 bytes there."""
    B, bs, S = 2, 8, 512
    gen = torch.Generator().manual_seed(0)
    tr = T.init_tree(64, B, torch.device("cpu"))
    logits = torch.randn(B, 128, generator=gen) * 4
    tr = T.seed_root(tr, torch.tensor([5, 9], dtype=torch.int32), 20, logits, 2)
    plan = T.select_batch(tr, bs, S)
    wire = []
    assert _fake_split("draft", _wire_world(wire, True)).plan(plan, B, bs, S) is plan
    assert wire[0].dtype == torch.int32 and wire[0].numel() * wire[0].element_size() == 33088
    got = _fake_split("target", _wire_world(wire, False)).plan(None, B, bs, S)
    assert got.node_ids is None
    for f in ("tokens", "positions", "rows", "mask", "parent_pos", "valid"):
        assert torch.equal(getattr(got, f), getattr(plan, f)), f
    verify = T.verify_walk(plan.tokens, plan.parent_pos, plan.valid,
                           torch.randint(0, 128, (B, bs), generator=gen, dtype=torch.int32))
    buf = pack(verify)
    assert buf.numel() * buf.element_size() == 160
    assert all(torch.equal(a, b) for a, b in zip(unpack(buf, verdict_widths(bs)), verify))


def test_split_engines_refuse_a_wrong_placement():
    """A split engine takes its role's model and a stand-in for the other,
    on the split's device and role group, and no device groups; a pair on
    disjoint groups without a split names the launch with one process per
    rank; ``make_split`` needs ranks for both roles; a buffer of another
    shape or type does not cross."""
    cfg = get_config("llama3-1b", smoke=True)
    split = _fake_split("target", _wire_world([], True))
    own, other = make_model(cfg, "cpu"), StandIn(cfg)
    eng = SpecEngine(own, other, SpecConfig(), 64, 64, split=split)
    assert eng.runs_target and not eng.runs_draft and eng.multi_process and eng.streams is None
    for t, d in ((other, own), (own, own), (other, other)):
        with pytest.raises(ValueError, match="StandIn"):
            SpecEngine(t, d, SpecConfig(), 64, 64, split=split)
    with pytest.raises(ValueError, match="target_devices"):
        SpecEngine(own, other, SpecConfig(), 64, 64, split=split,
                   target_devices=(torch.device("cpu"),))
    sharded = make_model(cfg, "cpu", TPGroup(pg=None, rank=0, world=2, device=torch.device("cpu"),
                                             backend="gloo", ranks=(0, 1)))
    with pytest.raises(ValueError, match="Split.models"):
        SpecEngine(sharded, other, SpecConfig(), 64, 64, split=split)
    with pytest.raises(ValueError, match="one process per rank"):
        SpecEngine(own, sharded, SpecConfig(), 64, 64)
    grp = TPGroup(pg=None, rank=0, world=2, device=torch.device("cpu"), backend="gloo",
                  ranks=(0, 1))
    for n_target in (0, 2):
        with pytest.raises(ValueError, match="n_target"):
            make_split(grp, n_target)
    with pytest.raises(ValueError, match="int32"):
        split.share(torch.zeros(2, 3), "target", (2, 3))
    with pytest.raises(ValueError, match="int32"):
        split.share(torch.zeros(2, 4, dtype=torch.int32), "target", (2, 3))


def test_crossed_exchanges_deadlock_and_the_time_limit_ends_them(tmp_path, monkeypatch):
    """Each role waits for the other's buffer: no rank sends, both wait, and
    ``run_ranks`` kills them at its limit instead of hanging."""
    monkeypatch.setenv("PYTHONPATH", str(HERE))  # the rank program below lives beside the tests
    with pytest.raises(TimeoutError, match="ran past"):
        run_ranks("_split_probe:crossed_exchange", 2, (), workdir=tmp_path, device="cpu",
                  timeout_s=15)
